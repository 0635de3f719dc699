"""Which collectives and point-to-point calls gloo runs on CUDA tensors,
with two processes sharing one card, and what an all-reduce and an
all-gather of the model axis's shapes and a hand-off of the pipe axis's
cost there.

NCCL takes one rank a device, so on a machine with one card the model
axis of ``aptai_tpu_torch.parallel`` runs as two processes over gloo,
which carries CUDA tensors through host memory. This script decides that
layout: it tries each collective the tensor- and sequence-parallel paths
use (``parallel/tensor.py``, ``infer/api.py::MeshRows``), a 1 x 2
``DeviceMesh`` on the card and a ``DistributedDataParallel`` over its data
axis, then times an all-reduce and a list all-gather of a bf16 (8, 249,
1024) tensor (a sublayer's output at the 8 x 5 s train step) and a (32,
499, 1024) one (at the 32 x 10 s serving batch).

Then the pipe axis's hand-offs (``parallel/pipeline.py``): ``send`` /
``recv``, ``isend`` / ``irecv`` and ``batch_isend_irecv`` of a CUDA tensor
from rank 0 to rank 1, each in a pair of processes of its own (a
transport that is handed a device pointer may crash or hang its pair, and
the pair is then killed after ``P2P_TIMEOUT`` seconds), and the time of
one hand-off of a bf16 (2, 249, 1024) microbatch (the 8 x 5 s batch in 4
microbatches) there: through each call that gloo accepts, and staged
through a pinned host buffer (device to host, send, receive, host to
device). Run it on the card's machine from the repository root:

    python3 scripts/gloo_cuda_collectives.py

Each rank prints one ``RES<rank>`` line of JSON, each rank of a
point-to-point pair one ``P2P`` line of JSON (its error where the call
failed) and the script the pair's exit codes; the card's name and power
limit follow.
"""

import json
import os
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


P2P_CALLS = ("send_recv", "isend_irecv", "batch_isend_irecv", "staged")
P2P_SHAPE = (2, 249, 1024)  # a microbatch of the 8 x 5 s batch, M = 4
P2P_TIMEOUT = 90  # seconds a point-to-point pair may take


def p2p(call: str, t: torch.Tensor, rank: int) -> None:
    """Hand ``t`` from rank 0 to rank 1 (rank 1 receives into ``t``)."""
    peer = 1 - rank
    if call == "send_recv":
        (dist.send if rank == 0 else dist.recv)(t, peer)
    elif call == "isend_irecv":
        (dist.isend if rank == 0 else dist.irecv)(t, peer).wait()
    elif call == "batch_isend_irecv":
        op = dist.isend if rank == 0 else dist.irecv
        for work in dist.batch_isend_irecv([dist.P2POp(op, t, peer)]):
            work.wait()
    else:  # staged through a pinned host buffer, as parallel/pipeline.py
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        if rank == 0:
            host.copy_(t)
            dist.send(host, peer)
        else:
            dist.recv(host, peer)
            t.copy_(host)
    torch.cuda.synchronize()


def p2p_main(call: str, rank: int, port: int) -> None:
    """One rank of a point-to-point pair: a small exact hand-off, then the
    mean time of a (2, 249, 1024) bf16 hand-off over 10 after 2 warm."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    res = {"call": call, "rank": rank}
    try:
        t = (torch.arange(8, device=dev, dtype=torch.float32) + 1
             if rank == 0 else torch.zeros(8, device=dev))
        p2p(call, t, rank)
        res["exact"] = bool((t == torch.arange(8, device=dev) + 1).all())
        big = torch.randn(P2P_SHAPE, device=dev).to(torch.bfloat16)
        for _ in range(2):
            p2p(call, big, rank)
        dist.barrier()
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            p2p(call, big, rank)
        ms = (time.perf_counter() - t0) / n * 1e3
        res["ms"] = ms
        res["GB_per_s"] = big.numel() * big.element_size() / ms / 1e6
    except Exception as e:  # the point is which ones raise
        res["error"] = f"{type(e).__name__}: {str(e)[:200]}"
    print("P2P " + json.dumps(res), flush=True)
    os._exit(0)  # a pair whose transport failed may not shut down


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_pair(args, timeout):
    """Start two ranks with ``args``; their exit codes (None: killed at
    ``timeout``), and no process outlives the call."""
    procs = [subprocess.Popen([sys.executable, __file__, *args[:1], str(r),
                               *args[1:]]) for r in range(2)]
    deadline = time.perf_counter() + timeout
    rcs = []
    try:
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(deadline - time.perf_counter(),
                                              1)))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    rcs = run_pair(["--rank", "2", str(free_port())], 300)
    for call in P2P_CALLS:
        got = run_pair([f"--p2p-{call}", str(free_port())], P2P_TIMEOUT)
        print(f"P2P {call} exit codes {got}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0 if rcs == [0, 0] else 1


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
        sys.exit(0)
    if sys.argv[1:2] and sys.argv[1].startswith("--p2p-"):
        p2p_main(sys.argv[1][len("--p2p-"):], int(sys.argv[2]),
                 int(sys.argv[3]))
    sys.exit(main())
