"""Multi-device on the port: panel-sharded inversion over a
``torch.distributed`` mesh (port of ``examples/04_multichip.py``).

    python examples/torch_04_multichip.py                        # every card
    python examples/torch_04_multichip.py cpu                    # 8 gloo CPU ranks
    torchrun --nproc-per-node 8 examples/torch_04_multichip.py   # 8 cards

Without torchrun the script starts the ranks itself with ``spawn_ranks``:
one NCCL rank per card (world size 1 on one card), or, with ``cpu``, 8
gloo ranks on the CPU. Under torchrun each rank drives one card over
NCCL. Every rank runs the same calls (``parallel.launch.run_calls``).
"""
import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))  # run as a script without installing
import gpu_matrix_inversion_tpu_torch as mi
from gpu_matrix_inversion_tpu_torch.parallel import launch, spawn_ranks


def calls(world: int):
    n = 512
    a = np.random.default_rng(4).uniform(0, 100, (n, n)).astype(np.float32)
    np.fill_diagonal(a, 0)
    batch = np.stack([a[:128, :128]] * 4) + np.eye(128, dtype=np.float32)
    dp = 2 if world % 2 == 0 else 1
    return [
        # 1-D tensor-parallel: columns over every rank.
        (mi.inverse, (world,), ("x",), (a,),
         dict(method="sharded", block_size=64)),
        # 2-D dp x tp: batch over dp, columns over tp ((1, 1) on one card).
        (mi.sharded_batched_inverse, (dp, world // dp), ("dp", "tp"),
         (batch,), dict(block_size=32)),
    ]


if __name__ == "__main__":
    if "WORLD_SIZE" in os.environ:          # torchrun: one card per rank
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        dist.init_process_group("nccl",
                                timeout=datetime.timedelta(seconds=600))
        try:
            world, kind = dist.get_world_size(), "cuda"
            results = [launch.run_calls(calls(world))]
        finally:
            dist.destroy_process_group()
    else:
        if sys.argv[1:] == ["cpu"]:         # 8 gloo ranks on the CPU
            world, kind = 8, "cpu"
        elif torch.cuda.is_available():     # one NCCL rank per card
            world, kind = torch.cuda.device_count(), "cuda"
        else:
            raise SystemExit("no CUDA card: pass 'cpu' to run on 8 gloo "
                             "ranks on the CPU")
        results = spawn_ranks(world, launch.run_calls, calls(world),
                              device_type=kind)
    print(f"world of {world} {kind} ranks")
    (_, ok), (_, okb) = (r["out"] for r in results[0])
    print("sharded ok:", bool(ok))
    print("dp x tp ok:", bool(okb.all()))
