"""One gloo rank of tests/test_torch_moe_ep.py: runs the port's moe_apply on
a (2, 2) and a (1, 4) mesh over 4 processes on the CPU, at each capacity
setting and FSDP mode, and (rank 0) writes the outputs to an .npz.

    python tests/_torch_moe_ep_worker.py RANK PORT INPUTS.npz OUTPUTS.npz
"""

import sys

import numpy as np
import torch
import torch.distributed as dist

CASES = (((2, 2), "gather"), ((2, 2), "partial"), ((1, 4), "gather"))
CAPACITIES = {"nodrop": (0.0, 1.0), "default": (1.25, 2.0)}


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
    x = torch.from_numpy(data["x"])
    meshes = {shape: make_test_mesh(*shape) for shape in {s for s, _ in CASES}}
    out = {}
    for (shape, mode) in CASES:
        for cap_name, (cf, slack) in CAPACITIES.items():
            y, aux = moe.moe_apply(p, x, cfg, mesh=meshes[shape], capacity_factor=cf,
                                   cap_slack=slack, fsdp_mode=mode)
            tag = f"{shape[0]}x{shape[1]}_{mode}_{cap_name}"
            out[f"out_{tag}"], out[f"aux_{tag}"] = y.numpy(), aux.numpy()
    y, aux = moe.moe_apply(p, x, cfg, capacity_factor=0.0)
    out["out_single"], out["aux_single"] = y.numpy(), aux.numpy()
    if rank == 0:
        np.savez(outputs, **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
