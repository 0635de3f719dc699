"""Which collectives gloo runs on CUDA tensors, with two processes sharing
one card, and what an all-reduce and an all-gather of the model axis's
shapes cost there.

NCCL takes one rank a device, so on a machine with one card the model
axis of ``aptai_tpu_torch.parallel`` runs as two processes over gloo,
which carries CUDA tensors through host memory. This script decides that
layout: it tries each collective the tensor- and sequence-parallel paths
use (``parallel/tensor.py``, ``infer/api.py::MeshRows``), a 1 x 2
``DeviceMesh`` on the card and a ``DistributedDataParallel`` over its data
axis, then times an all-reduce and a list all-gather of a bf16 (8, 249,
1024) tensor (a sublayer's output at the 8 x 5 s train step) and a (32,
499, 1024) one (at the 32 x 10 s serving batch). Run it on the card's
machine from the repository root:

    python3 scripts/gloo_cuda_collectives.py

Each rank prints one ``RES<rank>`` line of JSON; the card's name and power
limit follow.
"""

import json
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist


def rank_main(rank: int, world: int, port: int) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    res = {}

    def x(dtype=torch.float32, n=8):
        return (torch.arange(n, device=dev) + rank).to(dtype)

    tests = {
        "all_reduce_f32": lambda: dist.all_reduce(x()),
        "all_reduce_bf16": lambda: dist.all_reduce(x(torch.bfloat16)),
        "all_reduce_max": lambda: dist.all_reduce(x(), op=dist.ReduceOp.MAX),
        "all_reduce_int32": lambda: dist.all_reduce(x(torch.int32)),
        "all_gather_list": lambda: dist.all_gather(
            [torch.empty(8, device=dev) for _ in range(world)], x()),
        "all_gather_list_bf16": lambda: dist.all_gather(
            [torch.empty(8, device=dev, dtype=torch.bfloat16)
             for _ in range(world)], x(torch.bfloat16)),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * world, device=dev), x()),
        "reduce_scatter_list": lambda: dist.reduce_scatter(
            torch.empty(8 // world, device=dev), list(x().chunk(world))),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // world, device=dev), x()),
        "broadcast": lambda: dist.broadcast(x(), 0),
    }
    for name, fn in tests.items():
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "ok"
        except Exception as e:  # the point is which ones raise
            res[name] = f"{type(e).__name__}: {str(e)[:160]}"
    try:
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cuda", (1, world),
                                mesh_dim_names=("data", "model"))
        t = x()
        dist.all_reduce(t, group=mesh.get_group("model"))
        torch.cuda.synchronize()
        res["device_mesh_cuda_gloo"] = "ok"
        lin = torch.nn.Linear(8, 8).to(dev)
        ddp = torch.nn.parallel.DistributedDataParallel(
            lin, device_ids=[0], process_group=mesh.get_group("data"),
            broadcast_buffers=False)
        ddp(torch.randn(4, 8, device=dev)).sum().backward()
        torch.cuda.synchronize()
        res["ddp_cuda_gloo_data1"] = "ok"
    except Exception as e:
        res["device_mesh_or_ddp"] = f"{type(e).__name__}: {str(e)[:200]}"
    for name, shape in (("train_8x249x1024_bf16", (8, 249, 1024)),
                        ("serve_32x499x1024_bf16", (32, 499, 1024))):
        t = torch.randn(shape, device=dev).to(torch.bfloat16)
        for _ in range(2):
            dist.all_reduce(t)
        torch.cuda.synchronize()
        dist.barrier()
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            dist.all_reduce(t)
        torch.cuda.synchronize()
        res[name + "_all_reduce_ms"] = (time.perf_counter() - t0) / n * 1e3
        parts = [torch.empty_like(t) for _ in range(world)]
        t0 = time.perf_counter()
        for _ in range(n):
            dist.all_gather(parts, t)
        torch.cuda.synchronize()
        res[name + "_all_gather_ms"] = (time.perf_counter() - t0) / n * 1e3
    res["torch"] = torch.__version__
    print(f"RES{rank} " + json.dumps(res), flush=True)
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, __file__, "--rank", str(r),
                               "2", str(port)]) for r in range(2)]
    try:
        rcs = [p.wait(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return max(rcs)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
        sys.exit(0)
    sys.exit(main())
