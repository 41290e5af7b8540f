#!/usr/bin/env python3
"""Which torch.distributed collectives a ``gloo`` group takes on CUDA
tensors, for two processes sharing one card (``chip_smoke.py`` phase 16's
setting), and what a 50 MB bfloat16 all-reduce costs there.

    python3 tools/gloo_probe.py

Each collective runs in a pair of processes of its own, so a crash
(a segmentation fault, exit -11) shows as that case's exit codes and
stops nothing else: all_reduce (sum and max), all_gather_into_tensor,
reduce_scatter_tensor, all_gather and broadcast, each in float32,
bfloat16, float16, int32 and int64; a DeviceMesh over the card and a
DTensor's ``full_tensor`` (DTensor's functional collectives); and the
host-clock time of a 50 MB bfloat16 and a 100 MB float32 all-reduce
(median of 3, after one warm-up).  Prints one JSON line a case and the
card's name and power limit.  Needs a CUDA card; starts no process that
outlives it.
"""
import json
import socket
import statistics
import subprocess
import sys
import time

CASES = ("all_reduce", "all_reduce_max", "all_gather_into_tensor",
         "reduce_scatter_tensor", "all_gather", "broadcast", "dtensor",
         "timing")
DTYPES = ("float32", "bfloat16", "float16", "int32", "int64")


def rank_main(rank, port, case):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=2)
    res = {}

    def t(dt, n=4, v=None):
        x = torch.arange(n, device="cuda") if v is None else \
            torch.full((n,), float(v), device="cuda")
        return x.to(getattr(torch, dt))

    for dt in DTYPES if case not in ("dtensor", "timing") else ():
        if case == "all_reduce":
            x = t(dt, v=rank + 1)
            dist.all_reduce(x)
        elif case == "all_reduce_max":
            x = t(dt, v=rank + 1)
            dist.all_reduce(x, op=dist.ReduceOp.MAX)
        elif case == "all_gather_into_tensor":
            x = t(dt, 8)
            dist.all_gather_into_tensor(x, t(dt, v=rank + 1))
        elif case == "reduce_scatter_tensor":
            x = t(dt, 2)
            dist.reduce_scatter_tensor(x, t(dt))
        elif case == "all_gather":
            parts = [t(dt) for _ in range(2)]
            dist.all_gather(parts, t(dt, v=rank + 1))
            x = parts[1]
        else:
            x = t(dt, v=rank + 1)
            dist.broadcast(x, 0)
        torch.cuda.synchronize()
        res[dt] = x.tolist()
    if case == "dtensor":
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor, Replicate, Shard
        mesh = init_device_mesh("cuda", (1, 2),
                                mesh_dim_names=("data", "model"))
        d = DTensor.from_local(torch.full((2, 3), float(rank),
                                          device="cuda"), mesh,
                               [Replicate(), Shard(0)], run_check=False)
        res["full_tensor"] = d.full_tensor().tolist()
    if case == "timing":
        for name, n, dt in (("bf16_50MB", 25 << 20, torch.bfloat16),
                            ("f32_100MB", 25 << 20, torch.float32)):
            x = torch.ones(n, device="cuda", dtype=dt)
            times = []
            for i in range(4):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                dist.all_reduce(x)
                torch.cuda.synchronize()
                if i:
                    times.append((time.perf_counter() - t0) * 1e3)
            res[name + "_ms"] = statistics.median(times)
    if rank == 0:
        print("RESULT" + json.dumps(res), flush=True)
    dist.destroy_process_group()


def main():
    if len(sys.argv) == 4:
        rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
        return 0
    import torch
    if not torch.cuda.is_available():
        print("gloo_probe: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(dict(torch=torch.__version__, cuda=torch.version.cuda,
                          python=sys.version.split()[0])))
    for case in CASES:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        procs = [subprocess.Popen([sys.executable, __file__, str(r),
                                   str(port), case],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.DEVNULL, text=True)
                 for r in range(2)]
        try:
            outs = [p.communicate(timeout=150)[0] for p in procs]
            codes = [p.returncode for p in procs]
        except subprocess.TimeoutExpired:
            outs, codes = ["", ""], "timeout"
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        result = next((json.loads(line[6:]) for line in outs[0].splitlines()
                       if line.startswith("RESULT")), None)
        print(json.dumps(dict(case=case, exit_codes=codes, result=result)),
              flush=True)
    subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
