"""Which gloo collectives take CUDA tensors, and do they hand the next
kernel finished results? Ranks that share one card (the chip host's case,
where NCCL refuses two ranks on a device).

    python3 scripts/torch_gloo_probe.py        # on a CUDA host, about 30 s

Part 1, two ranks: ``all_reduce``, ``all_to_all_single``, ``all_gather``,
``all_gather_into_tensor`` and ``broadcast`` on CUDA tensors of float32,
int32, uint8, float16 and bfloat16, each reported ``ok`` or the error it
raised. Part 2, four ranks: ``repro_torch.dist``'s ``all_to_all_tiled``,
``all_gather_tiled`` and ``psum`` and a raw ``all_to_all_single`` on
200,000 x 10 float32 rows, each result read at once by a kernel on the
current stream and compared with the same sum on the CPU (the largest
difference; float32 summation order only). Prints one JSON line a part.
"""
import json
import os
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch import dist as rdist  # noqa: E402

N, D, W = 200_000, 10, 4
DTYPES = (torch.float32, torch.int32, torch.uint8, torch.float16, torch.bfloat16)


def accepts(group) -> dict:
    world, dev, res = group.world, torch.device("cuda", 0), {}
    for dt in DTYPES:
        x = (torch.arange(8 * world, device=dev) + 100 * group.rank).to(dt)
        for name, fn in (
                ("all_reduce", lambda: dist.all_reduce(x.clone())),
                ("all_to_all_single",
                 lambda: dist.all_to_all_single(torch.empty_like(x), x)),
                ("all_gather",
                 lambda: dist.all_gather([torch.empty_like(x) for _ in range(world)], x)),
                ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
                    torch.empty(world * x.numel(), dtype=dt, device=dev), x)),
                ("broadcast", lambda: dist.broadcast(x.clone(), 0))):
            try:
                fn()
                torch.cuda.synchronize()
                res[f"{name}/{str(dt)[6:]}"] = "ok"
            except Exception as e:  # noqa: BLE001 - the probe reports what raised
                res[f"{name}/{str(dt)[6:]}"] = f"{type(e).__name__}: {str(e)[:120]}"
            dist.barrier()
    return res


def rows(r: int) -> torch.Tensor:
    return torch.randn(W * N, D, generator=torch.Generator().manual_seed(r))


def exact(group) -> dict:
    dev, r = torch.device("cuda", 0), group.rank
    xs = [rows(p) for p in range(W)]
    want_a2a = torch.cat([xs[p][r * N:(r + 1) * N] for p in range(W)]).sum(1)
    want_gather = torch.cat([x[:N] for x in xs]).sum(1)
    want_psum = sum(x[:N] for x in xs)
    x = xs[r].to(dev)
    out = {}
    for _ in range(5):
        got = {"all_to_all_tiled": rdist.all_to_all_tiled(x, group).sum(1).cpu() - want_a2a,
               "all_gather_tiled": (rdist.all_gather_tiled(x[:N], group).sum(1).cpu()
                                    - want_gather),
               "psum": rdist.psum(x[:N], group).cpu() - want_psum}
        raw = torch.empty_like(x)
        dist.all_to_all_single(raw, x)
        got["raw all_to_all_single"] = raw.sum(1).cpu() - want_a2a
        for k, v in got.items():
            out[k] = max(out.get(k, 0.0), float(v.abs().max()))
    return out


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("torch_gloo_probe: needs a CUDA card")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    d = tempfile.mkdtemp()
    os.environ.setdefault("PYTHONHASHSEED", "0")
    print(json.dumps({"accepts": rdist.spawn_ranks(accepts, 2, device="cuda",
                                                   workdir=d)[0]}), flush=True)
    print(json.dumps({"largest_error": rdist.spawn_ranks(exact, W, device="cuda")}))
