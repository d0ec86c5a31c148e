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
