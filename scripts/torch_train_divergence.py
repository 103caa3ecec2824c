#!/usr/bin/env python3
"""Where the PyTorch port's full-width training trajectory parts from its
plain-PyTorch twin on the card.

    python3 scripts/torch_train_divergence.py [HASH_SEED] [ARCH]

Runs ``chip_smoke.py``'s training phase (30 steps from seed 0, B = 256, tier
flush at step 20) several times: on the kernels twice, on the plain
versions twice, on the plain versions under deterministic algorithms twice,
and on the kernels with one kernel at a time swapped for its plain version.
Prints each run's per-step absolute loss difference from the first kernel
run. The process re-runs itself under ``PYTHONHASHSEED=HASH_SEED`` (default
0, ``chip_smoke.py``'s): the seed fixes the packing salt, and with it which
rows the batches touch, so another seed is another realization of the data.
ARCH is ``deepfm`` (default) or ``dcn-v2``. Needs one CUDA card; each run
builds and frees a full-width state (9 GB for deepfm, 13.8 GB for dcn-v2).
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

SWAPS = {"_gather_pool_cuda": ref.gather_pool_ref,
         "_fm_interaction_cuda": ref.fm_interaction_ref,
         "_segment_grad_cuda": ref.segment_grad_ref,
         "_dedup_adagrad_cuda": ref.dedup_adagrad_ref,
         "_fm_interaction_bwd_cuda": ref.fm_interaction_bwd_ref,
         "_cross_layer_cuda": ref.cross_layer_ref,
         "_cross_layer_bwd_cuda": ref.cross_layer_bwd_ref}


def main(arch: str) -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_train_divergence: needs a CUDA card")
    torch.zeros(1, device=cs.DEV)  # the CUDA context, before the memory stats
    a = cs.ARCHS[arch]
    swaps = {k: v for k, v in SWAPS.items() if k[1:-5] in a.train_launches}
    stream = cs.batch_stream(cs.get_config(arch), cs.TRAIN_B, seed=cs.SEED)
    batches = [next(stream) for _ in range(cs.TRAIN_STEPS)]
    runs = {}
    for tag, fused in (("kernels", "auto"), ("kernels again", "auto"),
                       ("plain", "off"), ("plain again", "off")):
        runs[tag] = cs.train_run(arch, fused, batches)["losses"]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for tag in ("plain deterministic", "plain deterministic again"):
            runs[tag] = cs.train_run(arch, "off", batches)["losses"]
    finally:
        torch.use_deterministic_algorithms(False)
    for name, plain in swaps.items():
        kernel = getattr(ops, name)
        setattr(ops, name, plain)
        try:
            runs[f"kernels, plain {name[1:-5]}"] = cs.train_run(arch, "auto",
                                                                batches)["losses"]
        finally:
            setattr(ops, name, kernel)
    print(cs.card_stamp(), arch, f"PYTHONHASHSEED={os.environ['PYTHONHASHSEED']}")
    base = np.array(runs["kernels"])
    flush = cs.FLUSH_ITERS
    for tag, losses in runs.items():
        d = np.abs(np.array(losses) - base)
        print(f"{tag:34s} max {d.max():.3e}  steps 1-{flush} max {d[:flush].max():.3e}  "
              f"steps {flush + 1}-: " + " ".join(f"{x:.1e}" for x in d[flush:]))


if __name__ == "__main__":
    hash_seed = sys.argv[1] if len(sys.argv) > 1 else "0"
    if os.environ.get("PYTHONHASHSEED") != hash_seed:
        os.execve(sys.executable, [sys.executable, *sys.argv],
                  {**os.environ, "PYTHONHASHSEED": hash_seed})
    main(sys.argv[2] if len(sys.argv) > 2 else "deepfm")
