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

    return ModelConfig(**{f.name: getattr(jcfg, f.name)
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
