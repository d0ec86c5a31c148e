"""Helpers for the parity tests of the PyTorch port against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; outputs
come back as numpy and are compared at a stated tolerance.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

CPU = torch.device("cpu")


def np_tree(tree):
    """JAX pytree -> the same tree with numpy leaves (for models/convert.py)."""
    return jax.tree_util.tree_map(np.asarray, tree)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu().numpy() if x.is_floating_point() \
            else x.detach().cpu().numpy()
    return np.asarray(x, np.float32) if np.asarray(x).dtype.kind == "f" else np.asarray(x)


def close(a, b, rtol, atol):
    np.testing.assert_allclose(to_np(a), to_np(b), rtol=rtol, atol=atol)


def port_config(jcfg):
    """The port's ModelConfig with the fields of a reference config (e.g. a
    ``reduced()`` one, which the port has no method for)."""
    from repro_torch.common.config import ModelConfig

    return ModelConfig(**{f.name: getattr(jcfg, f.name, f.default)
                          for f in dataclasses.fields(ModelConfig)})


# --------------------------------------------------------------------------
# carrying the reference's head fits across (Table 1 and its ablations)
# --------------------------------------------------------------------------

def cut_sweeps_to_two_points(monkeypatch):
    """The S³/EGTP sweep cut to two points (num_bins 7 and 13 at the largest
    bin_max) in both packages, to keep a test short."""
    from repro.core import baselines as jbaselines
    from repro_torch.core import baselines

    for mod in (jbaselines, baselines):
        full = mod._bin_max_grid
        monkeypatch.setattr(mod, "S3_NUM_BINS_GRID", (7, 13))
        monkeypatch.setattr(mod, "_bin_max_grid", lambda L, full=full: full(L)[-1:])


def record_reference_fits(monkeypatch):
    """Make the reference's ``head_init`` record every head fit it starts.
    Its ``train_predictor`` turns the fit's key into both the head init and
    the minibatch seed (``src/repro/core/predictor.py:103, :120``). Returns
    (inits: (minibatch seed, d, hidden, K) -> numpy tree, seeds: the fits'
    seeds in call order), filled as the reference runs."""
    from repro.core import predictor as jpredictor

    inits, seeds = {}, []
    jhead_init = jpredictor.head_init

    def recording_head_init(key, d, hidden, K):
        seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
        inits[(seed, d, hidden, K)] = np_tree(jhead_init(key, d, hidden, K))
        seeds.append(seed)
        return jhead_init(key, d, hidden, K)

    monkeypatch.setattr(jpredictor, "head_init", recording_head_init)
    return inits, seeds


def carry_reference_inits(monkeypatch, inits):
    """The port's ``head_init`` gives the reference's recorded init of the
    seed and shape it is called with (the port keeps its 400-step cold-start
    floor)."""
    from repro_torch.core import predictor as tpredictor
    from repro_torch.models.convert import head_from_jax

    monkeypatch.setattr(tpredictor, "head_init",
                        lambda seed, d, hidden, K, device=None:
                        head_from_jax(inits[(seed, d, hidden, K)], device=device))


def carry_reference_seeds(monkeypatch, seeds, *modules):
    """Each ``train_predictor`` call of the port (through the name in each
    of ``modules``), in call order, trains with the seed the reference's fit
    at the same place in its order recorded. Returns the (port seed,
    reference seed) pairs, filled as the port runs: where the loops and seed
    maps agree, one port seed always meets one reference seed."""
    pending, pairs = iter(seeds), []
    for mod in modules:
        def carried(seed, *args, real=mod.train_predictor, **kwargs):
            ref_seed = next(pending)
            pairs.append((seed, ref_seed))
            return real(ref_seed, *args, **kwargs)

        monkeypatch.setattr(mod, "train_predictor", carried)
    return pairs


# --------------------------------------------------------------------------
# the reference's stacked trees in the port's per-layer layout
# --------------------------------------------------------------------------

def port_layout(tree, cfg):
    """The layout counterpart of ``models/convert.py::from_jax_params`` for
    trees of shapes, axes or specs: a reference parameter tree (or a
    ``cache_spec`` tree) laid out as the port's, each stacked leaf standing,
    as it is, for every layer it stacks. A cache entry becomes the port's
    ``(k, v[, k_s, v_s])`` tuple or ``{"h", "conv"}`` dict."""
    from repro_torch.models.transformer import layer_plan

    if cfg.family == "encdec":
        if "k" in tree:                                        # decoder_cache_spec
            return [dict(tree) for _ in range(cfg.n_layers)]
        return {"embed": tree["embed"], "enc_final_ln": tree["enc_final_ln"],
                "dec_final_ln": tree["dec_final_ln"],
                "encoder": [tree["encoder"]] * cfg.n_encoder_layers,
                "decoder": [tree["decoder"]] * cfg.n_layers}
    segments = tree if isinstance(tree, list) else tree["segments"]
    layers = []
    for seg, plan in zip(segments, layer_plan(cfg)):
        names = sorted(seg, key=lambda s: int(s.split("_")[1]))
        for _ in range(plan.n_blocks):
            layers.extend(seg[n] for n in names)
    if isinstance(tree, list):                                  # cache_spec
        return [e if "h" in e else tuple(e[k] for k in ("k", "v", "k_s", "v_s") if k in e)
                for e in layers]
    out = {k: v for k, v in tree.items() if k != "segments"}
    out["layers"] = layers
    return out


def flat_leaves(tree, is_leaf, prefix=""):
    """(path, leaf) pairs in ``repro_torch.common.pytree.tree_items`` order."""
    if is_leaf(tree):
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from flat_leaves(tree[k], is_leaf, f"{prefix}{k}/")
    else:
        for i, v in enumerate(tree):
            yield from flat_leaves(v, is_leaf, f"{prefix}{i}/")


def is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)
