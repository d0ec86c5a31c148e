"""The counters of operations and bytes against hand arithmetic at the
cells' shapes."""

from harness import common, flops
from harness.model import describe, n_params

QWEN = describe(common.config("qwen25-7b"))
MOE = describe(common.config("qwen3-moe-235b-a22b"))


def test_qwen_token_flops():
    attn = 3584 * (28 + 2 * 4) * 128 + 28 * 128 * 3584
    mlp = 3 * 3584 * 18944
    assert flops.token_flops(QWEN) == 2 * 28 * (attn + mlp) == 2 * 6_525_288_448


def test_moe_expert_bytes_a_step():
    assert flops.expert_bytes_all(MOE) == 12 * 128 * 3 * 4096 * 1536 * 2 == 57_982_058_496


def test_moe_token_flops_counts_routed_experts_and_router():
    attn = 4096 * (64 + 8) * 128 + 64 * 128 * 4096
    ffn = 8 * 3 * 4096 * 1536 + 4096 * 128
    assert flops.token_flops(MOE) == 2 * 12 * (attn + ffn)


def test_prefill_flops():
    lens = [5, 3]
    want = (flops.token_flops(QWEN) * 8 + 28 * 4 * 28 * 128 * (15 + 6)
            + 2 * 2 * 3584 * 152064 + 2 * 2 * (3584 * 512 + 512 * 64))
    assert flops.prefill_flops(QWEN, lens, 512, 64) == want


def test_step_bytes():
    layer = (3584 * 36 * 128 + 28 * 128 * 3584) + 3 * 3584 * 18944 + 2 * 3584
    want = (28 * layer + 3584 * 152064 + 3584 + 4 * 3584) * 2 + 28 * 2 * 100 * 4 * 128 * 2
    assert flops.step_bytes(QWEN, 4, 100) == want
    # all of the weights but the embedding table, once
    assert abs(flops.step_bytes(QWEN, 0, 0) / 2 - (n_params(QWEN) - 152064 * 3584)) < 1


def test_moe_step_bytes_with_routed_experts():
    full = flops.step_bytes(MOE, 128, 0)
    part = flops.step_bytes(MOE, 128, 0, experts_read=100)
    assert full - part == 12 * 28 * 3 * 4096 * 1536 * 2


def test_flash_and_decode_least():
    pk = common.PEAKS
    f = flops.flash_least_s(QWEN, [2048], pk)
    assert f == max(4 * 28 * 128 * 2048 * 2049 / 2 / pk["bf16_flops"],
                    2048 * (2 * 28 + 2 * 4) * 128 * 2 / pk["hbm_bytes_per_s"])
    assert flops.decode_attn_bytes(QWEN, 2, 10) == (2 * 10 * 4 + 2 * 2 * 28) * 128 * 2
