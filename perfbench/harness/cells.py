"""A run of one cell: set-up, the measured window, the traced sub-window and
the output check, for each kind of traffic mix.

The program under test is the port, ``repro_torch``, driven through the
entries a serving stack calls:

* ``admit``: per batch, what ``RealEngine.generate`` runs before its decode
  loop: ``Model.prefill(logits_mode="none")``, ``last_token_hidden``,
  ``Model.unembed`` of the last rows and ``RealEngine._sample``; then
  ``LengthPredictor.quantiles`` (one fused ``prod_head`` call); then the
  first tokens and the predictions on the host.
* ``collect``: whole ``RealEngine.generate`` calls back to back.

The window ends with the first unit of work (a batch, a call) that ends at
or after ``--seconds``; every unit counts, over the time to its end.
"""

from __future__ import annotations

import time
from contextlib import nullcontext
from types import SimpleNamespace
from typing import Any, Dict, List, Optional

import numpy as np

from harness import common, profile, traffic
from harness.common import log
from harness.model import make_head, make_params, seed_of


class StopCall(Exception):
    """Ends a generation call early (warm-up, traced steps)."""


class Probe:
    """The served model, seen through: counts decode steps, records the
    lengths each was given, calls ``on_step`` before each, and can end the
    call after ``stop_after`` steps. Everything else is the model's."""

    def __init__(self, model, stop_after: Optional[int] = None, on_step=None):
        self.model, self.stop_after, self.on_step = model, stop_after, on_step
        self.steps, self.lengths = 0, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def decode_step(self, *args, **kw):
        if self.stop_after is not None and self.steps >= self.stop_after:
            raise StopCall
        if self.on_step is not None:
            self.on_step(self.steps, kw)
        self.steps += 1
        return self.model.decode_step(*args, **kw)


class Routing:
    """Within the block, ``models/moe.py``'s ``_dispatch`` is wrapped from
    outside and each call's capacity, expert count, tokens and expert ids are
    kept (the ids as device tensors, read after the block)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.calls = moe, []

    def __enter__(self):
        self.orig = self.moe._dispatch

        def rec(local_ids, combine_w, E_local, capacity):
            out = self.orig(local_ids, combine_w, E_local, capacity)
            self.calls.append({"cap": int(capacity), "E": int(E_local),
                               "T": int(local_ids.shape[0]), "k": int(local_ids.shape[1]),
                               "ids": local_ids, "slot": out[3]})
            return out

        self.moe._dispatch = rec
        return self

    def __exit__(self, *exc):
        self.moe._dispatch = self.orig

    def summary(self) -> List[Dict[str, Any]]:
        import torch
        rows = []
        for c in self.calls:
            E = c["E"]
            counts = torch.zeros(E + 1, dtype=torch.long, device=c["ids"].device).scatter_add_(
                0, c["ids"].reshape(-1), torch.ones_like(c["ids"].reshape(-1)))[:E]
            rows.append({"cap": c["cap"], "E": E, "T": c["T"], "k": c["k"],
                         "experts_routed": int((counts > 0).sum()),
                         "dropped": int((c["slot"] == E * c["cap"]).sum())})
        return rows


class Cell:
    def __init__(self, name: str, seed: int, seconds: float, trace: bool,
                 device: str = "cuda"):
        self.name, self.seed, self.seconds, self.trace = name, seed, seconds, trace
        self.device = device            # "cpu" only in the harness's own tests
        self.wl = common.workload(name)
        self.cfg_json = common.config(self.wl["config"])
        self.mix = common.traffic(self.wl["traffic"])
        self.arch = common.arch_of(self.cfg_json)
        self.md = self.arch.describe(self.cfg_json)
        self.init = self.cfg_json["init"]
        self.serving = self.cfg_json.get("serving", {})
        self.kind = self.mix["kind"]
        self.split: Dict[str, float] = {}
        self.min_units = 0          # units the window runs at least (limit setting)

    # -- set-up -------------------------------------------------------------
    def setup(self):
        """Import the port and load its kernels, draw the weights and the
        inputs from the seed, and warm up every shape the window uses."""
        self.load_port()
        self.make_inputs()
        t = time.perf_counter()
        getattr(self, f"_setup_{self.kind}")()
        self.sync()
        self.split["warmup_s"] = time.perf_counter() - t

    def load_port(self):
        t = time.perf_counter()
        import torch
        from repro_torch.common.config import ModelConfig, PredictorConfig
        from repro_torch.core.predictor import LengthPredictor
        from repro_torch.kernels import _build
        from repro_torch.models.model_zoo import build_model, last_token_hidden
        from repro_torch.serving.engine import RealEngine
        self.torch, self.last_token_hidden, self.RealEngine = torch, last_token_hidden, RealEngine
        self.LengthPredictor, self.PredictorConfig = LengthPredictor, PredictorConfig
        self.dev = torch.device(self.device)
        if self.dev.type == "cuda":
            torch.cuda.init()
        self.split["import_s"] = time.perf_counter() - t
        t = time.perf_counter()
        for lib in (_build.KERNEL_SOURCES if self.dev.type == "cuda" else ()):
            _build.load(lib)
        self.split["kernels_s"] = time.perf_counter() - t
        fields = set(ModelConfig.__dataclass_fields__)
        self.port_cfg = ModelConfig(**{k: v for k, v in self.md.items() if k in fields})
        self.model = build_model(self.port_cfg,
                                 capacity_factor=self.serving.get("capacity_factor", 1.25))
        self.eos = self.serving.get("eos_id", 2)

    def make_inputs(self):
        t = time.perf_counter()
        self.params = make_params(self.arch.layout(self.md), self.md.get("dtype", "bfloat16"),
                                  self.init, self.seed, self.dev)
        self.head, self.edges = make_head(self.md, self.init, self.seed, self.dev)
        self.predictor = self.LengthPredictor(
            params=self.head, edges=self.edges,
            pcfg=self.PredictorConfig(n_bins=self.init["head_bins"],
                                      hidden=self.init["head_hidden"],
                                      bin_max=float(self.init["bin_max"])))
        self.sync()
        self.split["weights_s"] = time.perf_counter() - t

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize(self.dev)

    def _setup_admit(self):
        torch = self.torch
        V = self.md["vocab_size"]
        self.batches = traffic.admit_batches(self.mix, V, self.seed)
        self.engine = self.RealEngine(self.model, self.params,
                                      temperature=self.mix["temperature"], max_new=1,
                                      eos_id=self.eos)
        self.gen = torch.Generator(device=self.dev).manual_seed(seed_of(self.seed, 6))
        widths = sorted({b[0].shape[1] for b in self.batches})
        moe = self.md["family"] == "moe"
        with (Routing() if moe else nullcontext()) as rt:
            for w in widths:              # every shape the window uses, once
                toks, lens = next(b for b in self.batches if b[0].shape[1] == w)
                self._admit_one(toks, lens, keep=False)
        if moe:
            self._report_routing(rt, "warm-up prefills")
        log(f"perfbench: warm-up ran {len(widths)} batch widths {widths}")

    def _setup_collect(self):
        torch = self.torch
        mix = self.mix
        self.temps = torch.as_tensor(traffic.row_temperatures(mix), device=self.dev)
        self.engine = self.RealEngine(self.model, self.params, temperature=self.temps,
                                      max_new=mix["max_new"], eos_id=self.eos)
        prompts, plens = traffic.collect_call(mix, self.md["vocab_size"], self.seed, 0)
        probe = Probe(self.model, stop_after=mix.get("warmup_steps", 3))
        eng = self.RealEngine(probe, self.params, temperature=self.temps,
                              max_new=mix["max_new"], eos_id=self.eos)
        moe = self.md["family"] == "moe"
        with (Routing() if moe else nullcontext()) as rt:
            try:
                eng.generate(prompts, plens, torch.Generator(device=self.dev).manual_seed(1))
            except StopCall:
                pass
        if moe:
            self._report_routing(rt, "warm-up call")
        log(f"perfbench: warm-up ran one prefill of {prompts.shape} and {probe.steps} "
            f"decode steps")

    def _report_routing(self, rt: Routing, what: str):
        for i, c in enumerate(rt.summary()):
            log(f"perfbench: MoE {what}: call {i} (T={c['T']}, capacity {c['cap']}): "
                f"{c['dropped']} of {c['T'] * c['k']} (token, j) pairs dropped, "
                f"{c['experts_routed']} of {c['E']} experts routed")

    # -- admit ------------------------------------------------------------------
    def _admit_one(self, toks: np.ndarray, lens: np.ndarray, keep: bool, spans: bool = False):
        torch = self.torch
        dev = self.dev
        t0 = time.perf_counter()
        with profile.span("perfbench.prefill", spans):
            tokens = torch.as_tensor(toks, device=dev)
            ln = torch.as_tensor(lens, dtype=torch.int32, device=dev)
            valid = torch.arange(tokens.shape[1], device=dev)[None, :] < ln[:, None]
            _, hidden, _cache = self.model.prefill(self.params, tokens, attn_valid=valid,
                                                   logits_mode="none")
            del _cache
        with profile.span("perfbench.unembed_sample", spans):
            phi = self.last_token_hidden(hidden, ln)
            logits = self.model.unembed(self.params, phi)
            first = self.engine._sample(logits, self.gen)
        with profile.span("perfbench.head", spans):
            probs, quants = self.predictor.quantiles(phi, tuple(self.mix["quantiles"]))
        with profile.span("perfbench.to_host", spans):
            first.cpu()
            quants.cpu()
        t1 = time.perf_counter()
        unit = {"t_dispatch": t0, "t_done": t1, "B": int(len(lens)), "width": int(toks.shape[1]),
                "lens": [int(x) for x in lens]}
        if keep:
            unit["out"] = {"phi": phi, "logits": logits, "probs": probs, "quants": quants}
            unit["toks"] = toks
        return unit

    def window_admit(self) -> List[Dict[str, Any]]:
        nb = len(self.batches)
        units, i = [], 0
        t0 = time.perf_counter()
        while True:
            toks, lens = self.batches[i % nb]
            units.append(self._admit_one(toks, lens, keep=i < nb))
            i += 1
            if units[-1]["t_done"] - t0 >= self.seconds and len(units) >= self.min_units:
                break
        self.t0, self.t1 = t0, units[-1]["t_done"]
        return units

    def trace_admit(self, path):
        """``trace.batches`` batches after the window, traced."""
        nb = len(self.batches)
        n = self.mix["trace"]["batches"]
        moe = self.md["family"] == "moe"
        tr = profile.Tracer(path, self.dev.type == "cuda")
        done = []
        with (Routing() if moe else nullcontext()) as rt:
            with tr.window():
                for j in range(n):
                    toks, lens = self.batches[(len(self.units) + j) % nb]
                    done.append(self._admit_one(toks, lens, keep=False, spans=True))
        return tr, done, (rt.summary() if moe else None)

    # -- collect ----------------------------------------------------------------
    def window_collect(self) -> List[Dict[str, Any]]:
        torch = self.torch
        calls, c = [], 0
        t0 = time.perf_counter()
        while True:
            prompts, plens = traffic.collect_call(self.mix, self.md["vocab_size"], self.seed, c)
            gen = torch.Generator(device=self.dev).manual_seed(seed_of(self.seed, 5, c))
            ts = time.perf_counter()
            out = self.engine.generate(prompts, plens, gen, collect_hidden=True)
            te = time.perf_counter()
            unit = {"t_start": ts, "t_done": te, "rows": int(len(plens)),
                    "lens": [int(x) for x in plens], "max_new": self.mix["max_new"],
                    "gen_tokens": int(out["lengths"].sum())}
            if c == 0:
                unit["out"], unit["prompts"] = out, prompts
            calls.append(unit)
            c += 1
            if te - t0 >= self.seconds and len(calls) >= self.min_units:
                break
        self.t0, self.t1 = t0, calls[-1]["t_done"]
        return calls

    def trace_collect(self, path):
        """``trace.steps`` decode steps after ``trace.skip_steps`` of one more
        call, traced; the call ends there."""
        torch = self.torch
        mix = self.mix
        skip, n = mix["trace"]["skip_steps"], mix["trace"]["steps"]
        tr = profile.Tracer(path, self.dev.type == "cuda")
        moe = self.md["family"] == "moe"
        rt = Routing() if moe else nullcontext()
        ctx = {"span": None}

        def on_step(step, kw):
            if step == skip:
                rt.__enter__()
                tr.start()
            if skip <= step < skip + n:
                probe.lengths.append(kw["lengths"])
                if ctx["span"] is not None:
                    ctx["span"].__exit__(None, None, None)
                ctx["span"] = torch.profiler.record_function("perfbench.decode_step")
                ctx["span"].__enter__()

        probe = Probe(self.model, stop_after=skip + n, on_step=on_step)
        eng = self.RealEngine(probe, self.params, temperature=self.temps,
                              max_new=mix["max_new"], eos_id=self.eos)
        prompts, plens = traffic.collect_call(mix, self.md["vocab_size"], self.seed,
                                              len(self.units))
        try:
            eng.generate(prompts, plens, torch.Generator(device=self.dev).manual_seed(2))
        except StopCall:
            pass
        if ctx["span"] is not None:
            ctx["span"].__exit__(None, None, None)
        tr.stop()
        rt.__exit__(None, None, None)
        keys = [float(l.sum()) for l in probe.lengths]          # valid keys a step, per layer
        return tr, {"steps": n, "rows": int(len(plens)), "keys": keys}, (
            rt.summary() if moe else None)

    # -- the run ----------------------------------------------------------------
    def run(self) -> SimpleNamespace:
        torch = self.torch
        self.units = getattr(self, f"window_{self.kind}")()
        t_window_end = time.perf_counter()
        run = SimpleNamespace(kind=self.kind, md=self.md, mix=self.mix, init=self.init,
                              setup_s=self.setup_s, units=self.units, t0=self.t0, t1=self.t1,
                              peaks=common.PEAKS, flops=self.arch.flops, trace=None)
        run.memory_peak_bytes = None
        if self.dev.type == "cuda":
            run.memory_peak_bytes = torch.cuda.max_memory_allocated(self.dev)
            st = torch.cuda.memory_stats(self.dev)
            log(f"perfbench: allocator: peak reserved {st['reserved_bytes.all.peak']} bytes, "
                f"{st['num_alloc_retries']} allocation retries, {st['num_ooms']} OOMs")
        if self.trace:
            path = common.BUILD / f"trace-{self.name}.json.gz"
            tr, what, routing = getattr(self, f"trace_{self.kind}")(path)
            run.trace = tr.read()
            run.trace.update({"what": what, "routing": routing, "path": str(path)})
            log(f"perfbench: traced {run.trace['window_s']:.4f} s, busy "
                f"{run.trace['busy_s']:.4f} s, {run.trace['launches']} kernel launches; "
                f"trace in {path}")
        took = [u["t_done"] - u.get("t_start", u.get("t_dispatch")) for u in self.units]
        log(f"perfbench: window {self.t1 - self.t0:.3f} s, {len(self.units)} units "
            f"({t_window_end - self.t0:.3f} s to the check); a unit {min(took):.4f}-"
            f"{max(took):.4f} s, median {float(np.median(took)):.4f} s")
        return run


