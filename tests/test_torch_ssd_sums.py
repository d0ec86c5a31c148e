"""The fp32 SSD scan kernel's summation order, emulated in NumPy on the CPU.

``ssd_scan_fwd`` (``kernels/csrc/ssd_scan.cu``, fp32 inputs) sums C·Bᵀ over
N, the intra-chunk product and the state update over the chunk's 64 steps,
and C·h over N, each in blocks of ``kSum`` = 16 terms added to the
accumulator in order. This emulation repeats that arithmetic (an ``fmaf`` is
one rounding: the fp32 product is exact in fp64) on the inputs of the GPU
test ``test_ssd_scan_no_decay`` at S=65 (Zamba2's widths, a = 0). With one
chain over a whole chunk (kSum = 64) it gives 1.78e-4 against the fp64
recurrence, the kernel's reading on the H100 before the blocks; with blocks
of 16, 6.5e-5. The test holds the blocked sums below the single chains and
within 1.5x of the plain PyTorch version's error here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402

F32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small products on one thread: the suite runs in several worker
    processes at once, and threads beyond one per worker only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fma(a, b, c):
    return (a.astype(np.float64) * b.astype(np.float64) + c).astype(F32)


def _sum(a_terms, b_terms, k_sum):
    """sum_k a_k * b_k in fp32: fmaf chains of ``k_sum`` terms from 0, each
    added to the accumulator in order."""
    acc = None
    for k0 in range(0, len(a_terms), k_sum):
        part = F32(0)
        for a, b in zip(a_terms[k0:k0 + k_sum], b_terms[k0:k0 + k_sum]):
            part = _fma(a, b, part)
        acc = part if acc is None else (acc + part).astype(F32)
    return acc


def _kernel_y(x, dt, a, Bm, Cm, k_sum, Q=64):
    """y of ssd_scan_fwd's chunked form, fp32, summing in blocks of k_sum."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    h = np.zeros((B, H, P, N), F32)
    y = np.zeros_like(x)
    for c0 in range(0, S, Q):
        n = min(Q, S - c0)
        pad = lambda v: np.concatenate(
            [v[:, c0:c0 + n], np.zeros((B, Q - n) + v.shape[2:], F32)], axis=1)
        X, Bs, Cs, A, D = (pad(v) for v in (x, Bm, Cm, a, dt))
        cum = np.cumsum(A, axis=1, dtype=F32)                                # (B, Q, H)
        wdec = (np.exp(cum[:, -1:] - cum).astype(F32) * D).astype(F32)
        G = _sum([Cs[:, :, None, k] for k in range(N)], [Bs[:, None, :, k] for k in range(N)],
                 k_sum)                                                       # (B, i, j)
        L = np.exp(cum[:, :, None] - cum[:, None, :]).astype(F32)            # (B, i, j, H)
        low = np.tril(np.ones((Q, Q), bool))[None, :, :, None]
        Ss = np.where(low, ((G[..., None] * L).astype(F32) * D[:, None]).astype(F32), F32(0))
        yi = _sum([Ss[:, :, j, :, None] for j in range(Q)], [X[:, None, j] for j in range(Q)],
                  k_sum)                                                      # (B, i, H, P)
        yh = _sum([Cs[:, :, None, None, k] for k in range(N)],
                  [h[:, None, :, :, k] for k in range(N)], k_sum)
        y[:, c0:c0 + n] = (yi + (np.exp(cum)[..., None].astype(F32) * yh).astype(F32))[:, :n]
        st = _sum([(Bs[:, j, None, None, :] * wdec[:, j, :, None, None]).astype(F32)
                   for j in range(Q)], [X[:, j, :, :, None] for j in range(Q)], k_sum)
        h = ((np.exp(cum[:, -1]).astype(F32)[:, :, None, None] * h).astype(F32) + st).astype(F32)
    return y


def _fp64_y(x, dt, a, Bm, Cm):
    x, dt, a, Bm, Cm = (v.astype(np.float64) for v in (x, dt, a, Bm, Cm))
    h = np.zeros((x.shape[0], x.shape[2], x.shape[3], Bm.shape[-1]))
    ys = []
    for t in range(x.shape[1]):
        h = np.exp(a[:, t])[:, :, None, None] * h + np.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], Bm[:, t])
        ys.append(np.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return np.stack(ys, 1)


def test_blocked_sums_stay_near_fp64_with_no_decay():
    B, S, H, P, N = 2, 65, 64, 64, 64
    rng = np.random.default_rng(7)                       # test_ssd_scan_no_decay's draws
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H))))
    a = 0.0 * dt * np.exp(0.3 * rng.standard_normal(H))
    x, Bm, Cm = (rng.standard_normal(s) for s in ((B, S, H, P), (B, S, N), (B, S, N)))
    args = tuple(v.astype(F32) for v in (x, dt, a, Bm, Cm))
    exact = _fp64_y(*args)
    err = lambda y: float(np.abs(y.astype(np.float64) - exact).max())
    chained = err(_kernel_y(*args, k_sum=64))
    blocked = err(_kernel_y(*args, k_sum=16))
    plain = err(ref.ssd_scan_ref(*(torch.from_numpy(v) for v in args))[0].numpy())
    assert blocked < 0.5 * chained
    assert blocked <= 1.5 * plain, (blocked, plain)
