"""One gloo rank of tests/test_torch_moe_ep.py: runs the port's moe_apply on
a (2, 2) and a (1, 4) mesh over 4 processes on the CPU, at each capacity
setting and FSDP mode (and on the (2, 2) meshes also on 3 x 5 tokens, which
do not split over `data`), with the gradient of sum(y * c) beside each
output; rank 0 gathers every rank's gradients and writes them with the
outputs to an .npz.

    python tests/_torch_moe_ep_worker.py RANK PORT INPUTS.npz OUTPUTS.npz
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

CASES = (((2, 2), "gather"), ((2, 2), "partial"), ((1, 4), "gather"))
CAPACITIES = {"nodrop": (0.0, 1.0), "default": (1.25, 2.0)}
LEAVES = ("x", "router", "w_gate", "w_up", "w_down")


def run(moe, p, x, c, cfg, **kw):
    """moe_apply's output and aux, and the gradient of sum(y * c) with
    respect to x and each of p's leaves."""
    leaves = {"x": x.clone().requires_grad_(),
              **{k: v.clone().requires_grad_() for k, v in p.items()}}
    y, aux = moe.moe_apply({k: leaves[k] for k in p}, leaves["x"], cfg, **kw)
    grads = torch.autograd.grad((y * c).sum(), [leaves[k] for k in LEAVES])
    return y.detach().numpy(), aux.detach().numpy(), {k: g.numpy() for k, g in zip(LEAVES, grads)}


def main(rank: int, port: int, inputs: str, outputs: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4)
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe

    data = np.load(inputs)
    cfg = get_config("qwen3-moe-235b-a22b").reduced().with_overrides(
        dtype="float32", d_model=int(data["d"]), moe_d_ff=int(data["f"]),
        n_experts=int(data["E"]))
    p = {k: torch.from_numpy(data[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    x, c = torch.from_numpy(data["x"]), torch.from_numpy(data["c"])
    inputs = {"": (x, c), "_rep": (x[:3, :5], c[:3, :5])}
    meshes = {shape: make_test_mesh(*shape) for shape in {s for s, _ in CASES}}
    out, grads = {}, {}
    for (shape, mode) in CASES:
        for cap_name, (cf, slack) in CAPACITIES.items():
            for suffix, (xs, cs) in inputs.items():
                if suffix and shape != (2, 2):
                    continue
                tag = f"{shape[0]}x{shape[1]}_{mode}_{cap_name}{suffix}"
                out[f"out_{tag}"], out[f"aux_{tag}"], g = run(
                    moe, p, xs, cs, cfg, mesh=meshes[shape], capacity_factor=cf,
                    cap_slack=slack, fsdp_mode=mode)
                grads.update({f"grad_{tag}_{k}_r{rank}": v for k, v in g.items()})
    for suffix, (xs, cs) in inputs.items():
        tag = "single" + suffix
        out[f"out_{tag}"], out[f"aux_{tag}"], g = run(moe, p, xs, cs, cfg, capacity_factor=0.0)
        out.update({f"grad_{tag}_{k}": v for k, v in g.items()})
    every = [None] * 4 if rank == 0 else None
    dist.gather_object(grads, every, dst=0)
    if rank == 0:
        for g in every:
            out.update(g)
        np.savez(outputs, **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
