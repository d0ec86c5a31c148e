"""The plain reference of the served models: dense and MoE decoders in plain
PyTorch, in float32 with TF32 off, from the benchmark's own inputs (the
weights, the prompts, the tokens to judge). It imports nothing of the port
and takes nothing the port made: it works out again the routing, the K/V,
the last-token hidden state φ and the logits.

It replays what a serving call computed, layer by layer (one layer's weights
in float32 at a time, so that it fits beside the served weights): the
right-padded prompts of a batch, pads included (in a MoE layer a pad routes
and takes capacity, as in the port), then the decode steps on the tokens the
port served. The decode step t of row b feeds the token served at step t at
position ``pos[b, t]`` and attends to the row's real prompt keys and to the
decode keys of the steps before it; a row that emitted EOS at step t_f
feeds EOS at the same position from then on, which is the same item as at
t_f, so its later keys are that one key. A MoE layer dispatches the prompt
positions of the batch as one group (B x Sp tokens in row-major order) and
each decode step's B tokens as one group, each with its own capacity
(``int(T k cf / E) + 1``, at least 8 and at most T k): the (token, j) pairs
sorted stably by expert, the pairs past an expert's capacity dropped.

``precision="fp32r"`` is the float32 reference with the router's input
rounded to bf16 alone: the witness of how far routing near a tie moves a MoE
model's outputs, whatever the arithmetic elsewhere.

``precision="fp8"`` is the control: each matrix product's weight quantized
to float8 e4m3 per output column and its activation per row, the step a
later change to a bf16 model would be tempted to take. :func:`head` takes
``tf32=True`` for the head's control: its float32 products with both
operands rounded to TF32's 10-bit mantissa.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

F32 = torch.float32
F8_MAX = 448.0
ATTN_BYTES = 1 << 30        # fp32 score bytes an attention chunk may hold


@contextmanager
def exact_fp32():
    """float32 products without TF32, restored after."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(F32)


def _q8(x: torch.Tensor, dim: int) -> torch.Tensor:
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / F8_MAX
    return (x / s).to(torch.float8_e4m3fn).to(F32) * s


@dataclass
class Segment:
    """One serving call to replay. ``tokens`` (B, Sp) right-padded prompts,
    ``lens`` (B,) their lengths; ``dec_tokens`` (B, T) the tokens fed at
    decode steps 0 .. T-1 (None for a prefill alone), ``dec_pos`` (B, T)
    their positions, ``dec_last`` (B,) the last step whose key is new (the
    step a row emitted EOS at, else T - 1)."""

    tokens: torch.Tensor
    lens: torch.Tensor
    dec_tokens: Optional[torch.Tensor] = None
    dec_pos: Optional[torch.Tensor] = None
    dec_last: Optional[torch.Tensor] = None

    @property
    def T(self) -> int:
        return 0 if self.dec_tokens is None else self.dec_tokens.shape[1]


def decode_plan(served: torch.Tensor, lens: torch.Tensor, eos: int, steps: int):
    """What a generation call fed at its decode steps 0 .. steps-1, from the
    tokens it served (B, >= steps): the token, its position (the row's length
    so far; a finished row stays where it emitted EOS) and each row's last
    step with a new key."""
    B = served.shape[0]
    tok = served[:, :steps].to(torch.long)
    is_eos = tok == eos
    done_before = torch.cumsum(is_eos.to(torch.long), dim=1) - is_eos.to(torch.long) > 0
    first = torch.where(is_eos.any(dim=1), is_eos.to(torch.long).argmax(dim=1),
                        torch.full((B,), steps - 1, dtype=torch.long, device=tok.device))
    advanced = torch.cumsum((~(done_before | is_eos)).to(torch.long), dim=1)
    pos = lens.to(torch.long)[:, None] + torch.cat(
        [torch.zeros((B, 1), dtype=torch.long, device=tok.device), advanced[:, :-1]], dim=1)
    return tok, pos, first


class Reference:
    def __init__(self, md: Dict[str, Any], params: Dict[str, Any], precision: str = "fp32",
                 capacity_factor: float = 1.25):
        if precision not in ("fp32", "fp32r", "fp8"):
            raise ValueError(precision)
        self.md, self.p, self.precision, self.cf = md, params, precision, capacity_factor

    # -- products -------------------------------------------------------
    def weight(self, w: torch.Tensor, k: int) -> torch.Tensor:
        """A weight as a (k, n) float32 matrix (fp8-rounded per column in
        the control)."""
        w = w.reshape(k, -1).to(F32)
        return _q8(w, 0) if self.precision == "fp8" else w

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            x = _q8(x, -1)
        return x @ w

    # -- pieces -----------------------------------------------------------
    def rms(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = x.pow(2).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.md["norm_eps"]) * (1.0 + scale.to(F32))

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (B, N, heads, hd), pos (B, N): half-split rotation."""
        hd = x.shape[-1]
        half = hd // 2
        inv = 1.0 / (self.md["rope_theta"] ** (torch.arange(half, dtype=F32, device=x.device)
                                               / half))
        ang = pos.to(F32)[..., None] * inv
        cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)

    def mask(self, seg: Segment) -> torch.Tensor:
        """(B, N, N) which key item each query item attends to; items are
        the Sp prompt positions, then the T decode steps."""
        B, Sp = seg.tokens.shape
        T, dev = seg.T, seg.tokens.device
        N = Sp + T
        i = torch.arange(N, device=dev)
        lens = seg.lens.to(torch.long)[:, None, None]
        qi, kj = i[None, :, None], i[None, None, :]
        prompt_key = (kj < Sp) & (kj < lens) & ((kj <= qi) | (qi >= Sp))
        if not T:
            return prompt_key.expand(B, N, N)
        last = seg.dec_last.to(torch.long)[:, None, None]
        dec_key = (kj >= Sp) & (qi >= Sp) & (kj - Sp <= torch.minimum(qi - Sp, last))
        return prompt_key | dec_key

    def positions(self, seg: Segment) -> torch.Tensor:
        B, Sp = seg.tokens.shape
        pos = torch.arange(Sp, device=seg.tokens.device)[None].expand(B, Sp)
        return pos if not seg.T else torch.cat([pos, seg.dec_pos.to(torch.long)], dim=1)

    def attention(self, lp, x, pos, mask) -> torch.Tensor:
        md = self.md
        B, N, d = x.shape
        H, KV, hd = md["n_heads"], md["n_kv_heads"], md["head_dim"]
        G = H // KV
        a = lp["attn"]
        h = self.rms(x, lp["ln1"])
        wq, wk, wv = (self.weight(a[n], d) for n in ("wq", "wk", "wv"))
        wo = self.weight(a["wo"], H * hd)
        out = torch.empty_like(x)
        rows = max(1, ATTN_BYTES // (H * N * N * 4))
        for b0 in range(0, B, rows):
            sl = slice(b0, b0 + rows)
            hb = h[sl]
            q = self.mm(hb, wq).view(-1, N, H, hd)
            k = self.mm(hb, wk).view(-1, N, KV, hd)
            v = self.mm(hb, wv).view(-1, N, KV, hd)
            if md.get("qk_norm"):
                q, k = self.rms(q, a["q_norm"]), self.rms(k, a["k_norm"])
            q, k = self.rope(q, pos[sl]), self.rope(k, pos[sl])
            qg = q.view(-1, N, KV, G, hd)
            s = torch.einsum("bqkgh,bskh->bkgqs", qg, k) / math.sqrt(hd)
            s = s.masked_fill(~mask[sl][:, None, None], float("-inf"))
            o = torch.einsum("bkgqs,bskh->bqkgh", torch.softmax(s, dim=-1), v)
            out[sl] = self.mm(o.reshape(-1, N, H * hd), wo)
        return out

    def mlp(self, p, h) -> torch.Tensor:
        d = h.shape[-1]
        f = p["w_gate"].shape[-1]
        g = self.mm(h, self.weight(p["w_gate"], d))
        u = self.mm(h, self.weight(p["w_up"], d))
        return self.mm(torch.nn.functional.silu(g) * u, self.weight(p["w_down"], f))

    def kept(self, ids: torch.Tensor, E: int) -> torch.Tensor:
        """ids (G, Tg, k) -> (G, Tg, k) whether each pair got a slot of
        its expert: pairs sorted stably by expert in flat (token, j) order,
        the first ``capacity`` of each expert kept."""
        G, Tg, k = ids.shape
        M = Tg * k
        cap = max(8, min(int(Tg * k * self.cf / E) + 1, M))
        flat = ids.reshape(G, M)
        order = torch.argsort(flat, dim=1, stable=True)
        pos = torch.empty_like(order).scatter_(
            1, order, torch.arange(M, device=ids.device).expand(G, M).contiguous())
        counts = torch.zeros((G, E), dtype=torch.long, device=ids.device).scatter_add_(
            1, flat, torch.ones_like(flat))
        offsets = torch.cumsum(counts, dim=1) - counts
        rank = pos - torch.gather(offsets, 1, flat)
        return (rank < cap).view(G, Tg, k)

    def moe(self, p, h, Sp: int) -> torch.Tensor:
        md = self.md
        B, N, d = h.shape
        E, k = md["n_experts"], md["n_experts_per_token"]
        f = p["w_gate"].shape[-1]
        hr = h.to(torch.bfloat16).to(F32) if self.precision == "fp32r" else h
        probs = torch.softmax(self.mm(hr, self.weight(p["router"], d)), dim=-1)
        top_p, ids = torch.topk(probs, k, dim=-1)                       # (B, N, k)
        w = top_p / top_p.sum(dim=-1, keepdim=True)
        kept = torch.empty_like(ids, dtype=torch.bool)
        kept[:, :Sp] = self.kept(ids[:, :Sp].reshape(1, B * Sp, k), E).view(B, Sp, k)
        if N > Sp:
            kept[:, Sp:] = self.kept(ids[:, Sp:].transpose(0, 1), E).transpose(0, 1)
        hf, idf = h.reshape(B * N, d), ids.reshape(B * N, k)
        wf = (w * kept).reshape(B * N, k)
        sel_all = (idf[..., None] == torch.arange(E, device=h.device)) & kept.reshape(B * N, k, 1)
        out = torch.zeros_like(hf)
        for e in range(E):
            sel = sel_all[:, :, e]
            rows = torch.nonzero(sel.any(dim=1))[:, 0]
            if rows.numel() == 0:
                continue
            xe = hf[rows]
            g = self.mm(xe, self.weight(p["w_gate"][e], d))
            u = self.mm(xe, self.weight(p["w_up"][e], d))
            y = self.mm(torch.nn.functional.silu(g) * u, self.weight(p["w_down"][e], f))
            out.index_add_(0, rows, y * (wf[rows] * sel[rows]).sum(dim=1, keepdim=True))
        return out.view(B, N, d)

    # -- whole calls -------------------------------------------------------
    @torch.no_grad()
    def hidden(self, segs: List[Segment]) -> List[torch.Tensor]:
        """The final-normed hidden state (B, Sp + T, d) of every item of
        each segment, layer by layer over all segments."""
        with exact_fp32():
            xs = [self.p["embed"][s.tokens].to(F32) if not s.T else
                  torch.cat([self.p["embed"][s.tokens], self.p["embed"][s.dec_tokens]],
                            dim=1).to(F32) for s in segs]
            aux = [(self.positions(s), self.mask(s)) for s in segs]
            for lp in self.p["layers"]:
                for i, s in enumerate(segs):
                    x = xs[i]
                    x = x + self.attention(lp, x, *aux[i])
                    h = self.rms(x, lp["ln2"])
                    x = x + (self.moe(lp["moe"], h, s.tokens.shape[1]) if "moe" in lp
                             else self.mlp(lp["mlp"], h))
                    xs[i] = x
            return [self.rms(x, self.p["final_norm"]) for x in xs]

    @torch.no_grad()
    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """(..., d) final hidden states -> (..., V) float32 logits."""
        with exact_fp32():
            d = hidden.shape[-1]
            w = (self.p["embed"].T if self.md.get("tie_embeddings") else self.p["head"])
            return self.mm(hidden, self.weight(w, d))


@torch.no_grad()
def head(phi: torch.Tensor, hp: Dict[str, torch.Tensor], edges: torch.Tensor,
         qs, tf32: bool = False):
    """The ProD head: relu MLP, softmax over K bins, and each CDF level's
    quantile, linearly interpolated inside the bin where the CDF first
    reaches it (the last bin where rounding keeps it below)."""
    r = tf32_round if tf32 else (lambda t: t)
    with exact_fp32():
        x = phi.to(F32)
        h = torch.relu(r(x) @ r(hp["w1"]) + hp["b1"])
        probs = torch.softmax(r(h) @ r(hp["w2"]) + hp["b2"], dim=-1)
        cdf = torch.cumsum(probs, dim=-1)
        K = probs.shape[-1]
        q = torch.as_tensor(qs, dtype=F32, device=phi.device)
        hit = cdf[:, None, :] >= q[None, :, None]
        kstar = torch.where(hit.any(dim=-1), hit.to(torch.int8).argmax(dim=-1),
                            torch.full(hit.shape[:2], K - 1, device=phi.device))
        below = torch.where(kstar > 0, torch.gather(cdf, 1, (kstar - 1).clamp(min=0)),
                            torch.zeros((), device=phi.device))
        pk = torch.gather(probs, 1, kstar)
        t = ((q[None] - below) / pk.clamp(min=1e-12)).clamp(0.0, 1.0)
        left, right = edges[kstar], edges[kstar + 1]
        return probs, left + t * (right - left)
