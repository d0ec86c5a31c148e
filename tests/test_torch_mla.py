"""Multi-head latent attention and the sigmoid, held-block MoE layer of
Kimi-K2-Instruct in the port, against the benchmark's plain fp32 reference
(``perfbench/arch/mla.py``), on the CPU at tiny widths with seeded weights.

- ``Model.prefill``'s logits and φ; then prefill and decode steps through the
  latent cache against the reference's full forward over the same tokens.
- The absorbed decode against the expanded attention on the same cache.
- YaRN's frequencies and softmax scale at the published sizes, against the
  closed form (bands 0-19 kept, 20-31 divided by the factor).
- The sigmoid router: selection by score + bias, weights the unbiased
  scores normalised and scaled.
- The chip's share (model-configs guide section 4): with no drops, the 32
  blocks' outputs, the shared expert counted once, add up to the whole
  layer, in the port and in the reference; the counters keep to held pairs.
- At the published widths without allocating: the harness's layout is the
  port's parameter tree, the parameter count, the latent cache's bytes.
- On the card (``gpu``): the flash kernel at q/k 192, v 128 with a given
  scale against an fp32 product.
"""

import copy
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "perfbench"))

from harness import common, reference  # noqa: E402
from harness.model import leaves, make_params, n_params  # noqa: E402
from repro_torch.common import scopes  # noqa: E402
from repro_torch.common.config import ModelConfig  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.models import mla, moe, rope  # noqa: E402
from repro_torch.models.model_zoo import build_model  # noqa: E402
from repro_torch.models.transformer import layer_kinds, model_spec  # noqa: E402
from repro_torch.serving.engine import RealEngine  # noqa: E402

ARCH = common.arch("mla")
CPU = torch.device("cpu")
KIMI = common.config("kimi-k2-instruct")


def tiny_json(rank=1, ranks=4, held=4, layers=3, bias_std=0.05):
    """Kimi-K2-Instruct's configuration at tiny widths (fp32)."""
    cfg = copy.deepcopy(KIMI)
    cfg.update({"name": "tiny-mla", "hidden_size": 64, "intermediate_size": 96,
                "moe_intermediate_size": 32, "num_attention_heads": 4,
                "num_key_value_heads": 4, "q_lora_rank": 48, "kv_lora_rank": 32,
                "qk_nope_head_dim": 16, "qk_rope_head_dim": 8, "v_head_dim": 16,
                "num_hidden_layers": layers, "n_routed_experts": held,
                "expert_parallel": {"ranks": ranks, "rank": rank}, "vocab_size": 97,
                "torch_dtype": "float32", "num_experts_per_tok": 3,
                "rope_scaling": dict(KIMI["rope_scaling"], factor=4,
                                     original_max_position_embeddings=8)})
    cfg["init"] = dict(cfg["init"], router_bias_std=bias_std)
    return cfg


def port_cfg(md):
    fields = set(ModelConfig.__dataclass_fields__)
    return ModelConfig(**{k: v for k, v in md.items() if k in fields})


def tiny(seed=5, **kw):
    cfg = tiny_json(**kw)
    md = ARCH.describe(cfg)
    params = make_params(ARCH.layout(md), "float32", cfg["init"], seed, CPU)
    return md, port_cfg(md), params


def _batch(B=3, S=12, lens=(12, 7, 9), seed=0):
    g = torch.Generator().manual_seed(seed)
    tok = torch.randint(0, 97, (B, S), generator=g)
    lens = torch.tensor(lens)
    return tok, lens, torch.arange(S)[None] < lens[:, None]


HELD = {"rank1-of-4": dict(rank=1, ranks=4), "all": dict(rank=0, ranks=1),
        "rank3-of-4": dict(rank=3, ranks=4)}


@pytest.mark.parametrize("held", list(HELD))
def test_prefill_logits_and_phi_match_the_reference(held):
    md, cfg, params = tiny(**HELD[held])
    model = build_model(cfg)
    tok, lens, valid = _batch()
    logits, hidden, cache = model.prefill(params, tok, attn_valid=valid)
    r = ARCH.Reference(md, params, "fp32", 1.25)
    hid = r.hidden([reference.Segment(tok, lens)])[0]
    for b, n in enumerate(lens.tolist()):
        torch.testing.assert_close(logits[b, :n], r.logits(hid[b, :n]), rtol=0, atol=2e-5)
        torch.testing.assert_close(hidden[b, n - 1], hid[b, n - 1], rtol=0, atol=2e-5)
    assert layer_kinds(cfg) == ["full", "moe", "moe"]
    assert [tuple(e[0].shape) for e in cache] == [(3, 12, 40)] * 3


@pytest.mark.parametrize("held", ["rank1-of-4", "all"])
def test_decode_through_the_latent_cache_matches_the_full_forward(held):
    """Prefill, then 10 decode steps on given tokens, each step's logits
    against the reference's forward over prompt and steps."""
    md, cfg, params = tiny(**HELD[held])
    model = build_model(cfg)
    tok, lens, valid = _batch()
    T = 10
    fed = torch.randint(0, 97, (3, T), generator=torch.Generator().manual_seed(1))
    _, _, pc = model.prefill(params, tok, attn_valid=valid, logits_mode="none")
    cache = model.decode_cache(pc, tok.shape[1] + T)
    assert tuple(cache[0][0].shape) == (3, 12 + T, 40)
    got = []
    for t in range(T):
        pos = (lens + t).to(torch.int32)
        logits, _ = model.decode_step(params, fed[:, t], cache, pos=pos, lengths=pos + 1)
        got.append(logits)
    seg = reference.Segment(tok, lens, fed, lens[:, None] + torch.arange(T)[None],
                            torch.full((3,), T - 1))
    r = ARCH.Reference(md, params, "fp32", 1.25)
    want = r.logits(r.hidden([seg])[0][:, 12:])
    torch.testing.assert_close(torch.stack(got, dim=1), want, rtol=0, atol=3e-5)


def test_engine_serves_the_model():
    md, cfg, params = tiny()
    eng = RealEngine(build_model(cfg), params, temperature=1e-6, max_new=6, eos_id=2)
    tok, lens, _ = _batch()
    out = eng.generate(tok.numpy(), lens.numpy(), torch.Generator().manual_seed(0))
    assert out["tokens"].shape == (3, 6) and out["phi"].shape == (3, 64)
    # the greedy first token is the reference's argmax
    r = ARCH.Reference(md, params, "fp32", 1.25)
    hid = r.hidden([reference.Segment(tok, lens)])[0]
    first = r.logits(hid[torch.arange(3), lens - 1]).argmax(dim=-1)
    assert out["tokens"][:, 0].tolist() == first.tolist()


def test_absorbed_decode_equals_the_expanded_attention():
    """The decode step's attention (W_UK folded into q, an MQA over the
    latent, W_UV after) against K and V expanded from the same cache
    through the flash kernel's plain version."""
    md, cfg, params = tiny()
    p = params["layers"][1]["attn"]
    B, Sc, H, n, c, R = 3, 9, 4, 16, 16, 32
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, 1, 64, generator=g)
    cache = torch.randn(B, Sc, R + 8, generator=g)
    pos = torch.tensor([4, 8, 0])
    ang = mla.rope_angles(cfg, pos[:, None])
    got = mla.mla_decode(p, x, cfg, ang, cache, torch.arange(B), pos, pos + 1)
    q_nope, q_pe = mla._query(p, x, cfg, ang)
    kv = torch.einsum("bsr,rhk->bshk", cache[..., :R], p["wkv_b"])
    k = torch.cat([kv[..., :n], cache[:, :, None, R:].expand(B, Sc, H, 8)], dim=-1)
    o = torch.stack([ref.flash_attention_ref(
        torch.cat([q_nope, q_pe], dim=-1)[b:b + 1], k[b:b + 1, :int(pos[b]) + 1],
        kv[b:b + 1, :int(pos[b]) + 1, :, n:], causal=False, scale=mla.softmax_scale(cfg))[0]
        for b in range(B)])
    want = o.reshape(B, 1, H * c) @ p["wo"].reshape(H * c, 64)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_yarn_at_the_published_sizes():
    md = ARCH.describe(KIMI)
    cfg = port_cfg(md)
    assert rope.yarn_range(64, 50000, 4096, 1, 1) == (19, 20)
    i = torch.arange(32, dtype=torch.float64)
    plain = 50000.0 ** (-i / 32)
    closed = torch.where(i <= 19, plain, plain / 32)
    got = mla.rope_angles(cfg, torch.ones(1, 1))[0, 0]
    torch.testing.assert_close(got.double(), closed, rtol=2e-6, atol=0)
    torch.testing.assert_close(ARCH.inv_freq(md, 64, CPU), got, rtol=0, atol=0)
    want = 192 ** -0.5 * (0.1 * math.log(32) + 1) ** 2
    assert abs(mla.softmax_scale(cfg) - want) < 1e-12 and round(want, 5) == 0.13086
    assert ARCH.softmax_scale(md) == pytest.approx(want, rel=1e-12)


def test_sigmoid_router_selects_by_bias_and_weights_by_score():
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0, 0.0]])
    bias = torch.tensor([0.0, 0.0, 0.0, 0.9, 0.0])
    ids, w, aux = moe._router_sigmoid(logits, bias, 2, 2.827)
    assert ids.tolist() == [[3, 0]]            # expert 3 by its bias, over 1 and 2
    s = torch.sigmoid(logits[0, [3, 0]])
    torch.testing.assert_close(w[0], s / s.sum() * 2.827)
    assert torch.isfinite(aux)


@pytest.mark.parametrize("side", ["port", "reference"])
def test_the_32_blocks_add_up_to_the_whole_layer(side):
    """With no drops (capacity of every pair), each block of 2 of 64
    experts computes its part; summed over the 32 blocks, with the shared
    expert counted once, they equal the layer that holds all 64."""
    E, blocks = 64, 32
    md, cfg, params = tiny(rank=0, ranks=1, held=E, layers=2)
    p = params["layers"][1]["moe"]
    h = torch.randn(2, 7, 64, generator=torch.Generator().manual_seed(2))
    Eh = E // blocks

    def block(i):
        sub = dict(p, w_gate=p["w_gate"][i * Eh:(i + 1) * Eh],
                   w_up=p["w_up"][i * Eh:(i + 1) * Eh], w_down=p["w_down"][i * Eh:(i + 1) * Eh])
        if side == "port":
            c = cfg.with_overrides(experts_held=Eh, expert_offset=i * Eh)
            return moe.moe_apply(sub, h, c, capacity_factor=0)[0]
        m = dict(md, experts_held=Eh, expert_offset=i * Eh)
        r = ARCH.Reference(m, params, "fp32", float(E))
        return r.moe(sub, h, 7) + r.mlp(p["shared"], h)

    if side == "port":
        whole = moe.moe_apply(p, h, cfg, capacity_factor=0)[0]
    else:
        r = ARCH.Reference(md, params, "fp32", float(E))
        whole = r.moe(p, h, 7) + r.mlp(p["shared"], h)
    shared = moe.mlp_apply(p["shared"], h, "silu")
    parts = sum(block(i) for i in range(blocks)) - (blocks - 1) * shared
    # 32 outputs summed and 31 shared experts taken off, in fp32: a few
    # units of 2^-24 of the largest term 32 times over
    tol = 16 * 2.0 ** -24 * blocks * float(torch.maximum(whole.abs(), shared.abs()).max())
    torch.testing.assert_close(parts, whole, rtol=0, atol=tol)


def test_counters_keep_to_the_held_pairs():
    """``moe.pairs`` counts the pairs routed to held experts and
    ``moe.dropped`` those of them past capacity, as a count from the
    router's own ids gives them."""
    md, cfg, params = tiny(rank=1, ranks=4, held=4, layers=2)
    p = params["layers"][1]["moe"]
    h = torch.randn(4, 16, 64, generator=torch.Generator().manual_seed(4))
    scopes.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        moe.moe_apply(p, h, cfg, capacity_factor=0.5)
    c = scopes.counters()
    scopes.reset_counters()
    logits = h.reshape(-1, 64) @ p["router"]
    ids = moe._router_sigmoid(logits, p["bias"], 3, cfg.routed_scale)[0]
    held = (ids >= 4) & (ids < 8)
    r = ARCH.Reference(md, params, "fp32", 0.5)
    kept = r.kept(ids[None], 16)[0]
    assert c["moe.pairs"] == int(held.sum()) < ids.numel()
    assert c["moe.dropped"] == int((held & ~kept).sum()) > 0


def _combine_every_row(ye, weight, slot):
    """The combine read over every (token, j) pair, zero rows included."""
    E, cap, d = ye.shape
    rows = (ye * weight[..., None].to(ye.dtype)).reshape(E * cap, d)
    rows = torch.cat([rows, rows.new_zeros(1, d)])
    slot = torch.sort(slot, dim=1).values
    out = torch.zeros((slot.shape[0], d), dtype=ye.dtype)
    for j in range(slot.shape[1]):
        out = out + rows[slot[:, j]]
    return out


@pytest.mark.parametrize("T,k,E,Eh,cf", [(256, 8, 384, 12, 1.25), (64, 3, 16, 4, 1.25),
                                         (96, 8, 64, 2, 0.5), (40, 4, 8, 8, 1.25)])
def test_held_combine_reads_fewer_rows_to_the_same_bits(T, k, E, Eh, cf):
    """A block of ``Eh`` of ``E`` experts leaves most pairs dropped here:
    the combine reads only as many tokens as can hold each j-th kept pair,
    with the sums bit for bit those over every pair (bf16)."""
    g = torch.Generator().manual_seed(T + k)
    ids = torch.topk(torch.rand(T, E, generator=g), k, dim=-1).indices
    held = moe._held_ids(ids, E - Eh, Eh)
    cap = moe._capacity(T, k, E, cf)
    combine = torch.rand(T, k, generator=g)
    _, _, weight, slot = moe._dispatch(held, combine, Eh, cap)
    ye = torch.randn(Eh, cap, 32, generator=g).to(torch.bfloat16)
    assert (Eh * cap // k < T) == (Eh < E)         # the short path is taken
    got = moe._combine(ye, weight, slot)
    assert torch.equal(got, _combine_every_row(ye, weight, slot))
    assert bool((slot < Eh * cap).any()) and bool(got.abs().sum() > 0)


def test_the_published_widths_without_allocating():
    """The harness's layout is the port's parameter tree, the leaves come to
    23,138,732,288 parameters, and the latent cache holds 576 values a
    token a layer."""
    md = ARCH.describe(KIMI)
    cfg = port_cfg(md)
    ours = {p: l.shape for p, l in leaves(ARCH.layout(md))}
    spec = model_spec(cfg)
    theirs = {}

    def walk(t, path=()):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, path + (k,))
        elif isinstance(t, list):
            for i, v in enumerate(t):
                walk(v, path + (i,))
        else:
            theirs[path] = tuple(t.shape)
    walk(spec)
    assert ours == theirs
    assert n_params(ARCH.layout(md)) == 23_138_732_288
    model = build_model(cfg)
    assert model.cache_bytes(8, 1000) == 31 * 8 * 1000 * 576 * 2
    assert ARCH.flops.kv_bytes(md, 1) == 31 * 1152


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the GPU)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,lens", [(2, 300, (300, 129)), (8, 2048, None)])
def test_flash_at_192_128_with_a_given_scale_on_the_card(B, S, lens):
    """The bf16 kernel with q/k of 192 columns and v of 128, MLA's scale,
    causal and ragged, against an fp32 product of the same bf16 values:
    within 2e-2 of sum |p| |v| a row, and a second call bit-identical."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    dev = _cuda()
    H = 64
    g = torch.Generator(device=dev).manual_seed(B * S)
    q, k = (torch.randn(B, S, H, 192, generator=g, device=dev).bfloat16() for _ in range(2))
    v = torch.randn(B, S, H, 128, generator=g, device=dev).bfloat16()
    kv = None if lens is None else torch.tensor(lens, dtype=torch.int32, device=dev)
    scale = 0.13086079996295008
    out = flash_attention_cuda(q, k, v, kv_lengths=kv, scale=scale)
    again = flash_attention_cuda(q, k, v, kv_lengths=kv, scale=scale)
    worst = 0.0
    for b in range(B):          # a batch row at a time, to bound the fp32 scores
        qb, kb, vb = (t[b:b + 1].float() for t in (q, k, v))
        kvb = None if kv is None else kv[b:b + 1]
        want = ref.flash_attention_ref(qb, kb, vb, kv_lengths=kvb, scale=scale)
        # each row's output scale: sum_k p |v|
        pv = ref.flash_attention_ref(qb, kb, vb.abs(), kv_lengths=kvb, scale=scale)
        err = (out[b:b + 1].float() - want).abs() / pv.amax(dim=-1, keepdim=True).clamp(min=1e-6)
        worst = max(worst, err.max().item())
    print(f"flash 192/128 B={B} S={S}: max err / row scale {worst:.3e}")
    assert out.shape == (B, S, H, 128) and torch.equal(out, again)
    assert worst < 2e-2
    with pytest.raises(ValueError):
        flash_attention_cuda(q.float(), k.float(), v.float())
