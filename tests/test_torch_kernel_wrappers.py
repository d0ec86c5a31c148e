"""The kernels' wrapper logic that runs on the host, on the CPU: the C
signatures the ctypes bindings assume, the dtype codes shared with the
sources, the library paths, the per-stream workspace, and the wrappers'
refusal of CPU tensors and of shapes their kernels do not take (a CPU tensor
goes to the plain version through ``ops``, never to a kernel wrapper)."""

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import prod_head as ph  # noqa: E402
from repro_torch.kernels import rms_norm as rn  # noqa: E402
from repro_torch.kernels import rope as rp  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402
from repro_torch.kernels import unembed as ue  # noqa: E402

WRAPPERS = {"prod_head": ph, "flash_attention": fa, "decode_attention": da, "ssd_scan": ss,
            "unembed": ue, "rms_norm": rn, "rope": rp}


def _c_params(name):
    """The parameter types of ``<name>_launch`` in ``csrc/<name>.cu``."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    m = re.search(rf'extern "C" int {name}_launch\(([^)]*)\)', src)
    assert m, f"{name}.cu defines no {name}_launch"
    return [" ".join(p.split()[:-1]) for p in m.group(1).split(",")]


@pytest.mark.parametrize("name", _build.KERNEL_SOURCES)
def test_ctypes_signature_matches_the_source(name):
    """``_build.entry`` declares pointers, then ints, then floats; the C entry
    point must take exactly that, or the call fails only on the card."""
    kinds = ["p" if "*" in t else "f" if t == "float" else "i" if t == "int" else t
             for t in _c_params(name)]
    wrapper = WRAPPERS[name].__file__
    m = re.search(rf'_build\.entry\("{name}", n_pointers=(\d+), n_ints=(\d+)'
                  r'(?:, n_floats=(\d+))?\)', open(wrapper).read())
    assert m, f"{wrapper} binds no {name}_launch"
    n_p, n_i, n_f = (int(g or 0) for g in m.groups())
    assert kinds == ["p"] * n_p + ["i"] * n_i + ["f"] * n_f


def test_dtype_codes_match_the_sources():
    src = (_build.CSRC / "common.cuh").read_text()
    codes = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert _build.DTYPE_CODES == {"float32": int(codes["kF32"]),
                                  "bfloat16": int(codes["kBF16"])}
    assert _build.TORCH_DTYPE_CODES == {torch.float32: int(codes["kF32"]),
                                        torch.bfloat16: int(codes["kBF16"])}


@pytest.mark.parametrize("name", _build.KERNEL_SOURCES)
def test_library_path_follows_sources_and_flags(name, monkeypatch):
    """One library per source, named after it; its hash covers the source,
    the shared headers and the flags, so an edit rebuilds it."""
    path = _build._lib_path(name)
    assert path.parent == _build.BUILD_DIR
    assert re.fullmatch(rf"lib{name}-[0-9a-f]{{16}}\.so", path.name)
    assert _build._lib_path(name) == path
    others = {_build._lib_path(n) for n in _build.KERNEL_SOURCES if n != name}
    assert path not in others
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build._lib_path(name) != path


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()


@pytest.mark.parametrize("err", [0, 1, 700])
def test_check_raises_on_a_cuda_error(err):
    if err == 0:
        _build.check(err, "kernel")
    else:
        with pytest.raises(RuntimeError, match=f"cudaError_t {err}"):
            _build.check(err, "kernel")


@pytest.fixture
def capturing(monkeypatch):
    """Whether a CUDA graph capture is on, as the workspace asks (the CPU
    build of torch cannot answer itself)."""
    state = {"on": False}
    monkeypatch.setattr(_build.torch.cuda, "is_current_stream_capturing",
                        lambda: state["on"])
    monkeypatch.setattr(_build, "_WORKSPACE", {})
    return state


def test_workspace_is_kept_per_kernel_device_and_stream(capturing):
    cpu = torch.device("cpu")
    s, c = _build.workspace("decode_attention", cpu, 1, 100, 8)
    assert s.dtype == torch.float32 and c.dtype == torch.int32
    again = _build.workspace("decode_attention", cpu, 1, 50, 4)
    assert again[0] is s and again[1] is c            # smaller calls reuse it
    assert _build.workspace("decode_attention", cpu, 2, 100, 8)[0] is not s
    assert _build.workspace("prod_head", cpu, 1, 100, 8)[0] is not s


def test_workspace_grows_and_counters_start_at_zero(capturing):
    cpu = torch.device("cpu")
    s, _ = _build.workspace("ssd", cpu, 1, 10, 0)
    assert s.numel() == 10
    s2, c2 = _build.workspace("ssd", cpu, 1, 1000, 16)
    assert s2.numel() == 1000 and c2.numel() == 16 and not c2.any()
    assert _build.workspace("ssd", cpu, 1, 10, 0)[0] is s2


def test_workspace_in_a_graph_capture_is_its_own(capturing):
    """A captured call gets a workspace the graph keeps, and the stream's
    own workspace is left as it was."""
    cpu = torch.device("cpu")
    eager = _build.workspace("decode_attention", cpu, 1, 100, 8)
    capturing["on"] = True
    captured = _build.workspace("decode_attention", cpu, 1, 100, 8)
    assert captured[0] is not eager[0] and captured[1] is not eager[1]
    capturing["on"] = False
    assert _build.workspace("decode_attention", cpu, 1, 100, 8)[0] is eager[0]


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(2, 8, 64)
    kv = torch.zeros(2, 10, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        da.decode_attention_cuda(q, kv, kv, torch.ones(2, dtype=torch.int32))
    x = torch.zeros(1, 8, 2, 64)
    dt = torch.zeros(1, 8, 2)
    Bm = torch.zeros(1, 8, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_scan_cuda(x, dt, dt, Bm, Bm)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(torch.zeros(2, 5, 8, 64), kv, kv)
    w1, w2 = torch.zeros(64, 32), torch.zeros(32, 16)
    with pytest.raises(ValueError, match="CUDA"):
        ph.prod_head_cuda(torch.zeros(2, 64), w1, torch.zeros(32), w2, torch.zeros(16),
                          torch.zeros(17), torch.tensor([0.5]))


@pytest.mark.parametrize("q,kv", [
    ((2, 8), (2, 10, 2, 64)),          # q not (B, H, hd)
    ((2, 8, 64), (2, 10, 64)),         # k not (B, Sc, KV, hd)
    ((2, 8, 48), (2, 10, 2, 48)),      # a head width the kernel does not take
    ((2, 6, 64), (2, 10, 4, 64)),      # H not a multiple of KV
], ids=["q-rank", "kv-rank", "hd", "groups"])
def test_decode_wrapper_refuses_shapes(q, kv):
    with pytest.raises(ValueError, match="must be|kernel takes"):
        da.decode_attention_cuda(torch.zeros(q), torch.zeros(kv), torch.zeros(kv),
                                 torch.ones(2, dtype=torch.int32))


@pytest.mark.parametrize("x,bm", [((8, 2, 64), (1, 8, 64)), ((1, 8, 2, 64), (1, 8, 1, 64))],
                         ids=["x-rank", "bm-rank"])
def test_ssd_wrapper_refuses_shapes(x, bm):
    dt = torch.zeros(1, 8, 2)
    with pytest.raises(ValueError, match="must be"):
        ss.ssd_scan_cuda(torch.zeros(x), dt, dt, torch.zeros(bm), torch.zeros(bm))


@pytest.mark.parametrize("phi,hidden,K", [((64,), 32, 16), ((2, 64), 33, 16),
                                          ((2, 64), 32, 129)], ids=["phi-rank", "hidden", "K"])
def test_prod_head_wrapper_refuses_shapes(phi, hidden, K):
    d = phi[-1]
    with pytest.raises(ValueError, match="expected|kernel takes"):
        ph.prod_head_cuda(torch.zeros(phi), torch.zeros(d, hidden), torch.zeros(hidden),
                          torch.zeros(hidden, K), torch.zeros(K), torch.zeros(K + 1),
                          torch.tensor([0.5]))


@pytest.mark.parametrize("name,pattern", [
    ("flash_attention", r"launch_sm90<(\d+)>\(FLASH_ARGS\)"),
    ("flash_attention", r"simt::launch<(\d+)>\(FLASH_ARGS\)"),
    ("decode_attention", r"by_group<T, (\d+)>\(gt"),
    ("decode_attention", r"hd == (\d+)"),
], ids=["flash-bf16", "flash-fp32", "decode-launch", "decode-valid"])
def test_head_dims_are_the_sources_instantiations(name, pattern):
    """The widths a wrapper lets through are the ones its source
    instantiates, for each dtype: Kimi-K2's 112 and Gemma3's 168 among them."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    widths = tuple(sorted({int(w) for w in re.findall(pattern, src)}))
    assert widths == WRAPPERS[name].HEAD_DIMS == (32, 64, 112, 128, 168)


@pytest.mark.parametrize("hd", [112, 96, 48])
def test_attention_wrappers_take_hd112_only_among_these(hd):
    """hd=112 passes the width check and reaches the device check (these
    tensors lie on the CPU); 96 and 48 are refused by width."""
    msg = "CUDA" if hd == 112 else "kernel takes"
    kv = torch.zeros(2, 10, 2, hd)
    with pytest.raises(ValueError, match=msg):
        fa.flash_attention_cuda(torch.zeros(2, 10, 8, hd), kv, kv)
    with pytest.raises(ValueError, match=msg):
        da.decode_attention_cuda(torch.zeros(2, 8, hd), kv, kv, torch.ones(2, dtype=torch.int32))
