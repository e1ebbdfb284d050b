#!/usr/bin/env python3
"""Times the port's hash and reduce kernels at the main path's shapes on
one NVIDIA GPU, for the package found under a given root.

Run from the root of a checkout on a machine with a CUDA card:

    python3 time_kernels.py [--root DIR] [--label NAME]

``--root`` names the directory holding the ``spark_rapids_tpu_torch``
package to time (default: this checkout), so that two versions of the
kernels can be timed in one call on one card, in turns (for example the
parent commit unpacked with ``git archive`` into a git-ignored directory:
parent, change, change, parent).  The inputs, the timing and the bound
are ``chip_smoke.py``'s own (``group_by_codes``, ``join_lanes``,
``q6_batch``, ``mmr_dense``, ``q6_merge``; ``time_insert``, ``time_probe``,
``time_mmr``), the same for every root:

- ``hash_insert`` at the hash group-by's shape (2^22 radix codes of 2^20
  keys, every row live, 2^21 slots) and at the fact-dim join's build
  shape (the 2^19 dim keys, 2^20 slots);
- ``hash_probe`` at the join's probe batch (2^22 fact keys, every row
  live, about half of them in the dim table, against its 2^20-slot
  table);
- ``masked_multi_reduce`` at q6's first batch (2^22 rows), at a
  sharded q6 shard's whole input (2^23 rows), at the dense check shape
  (2^26 rows, 3 columns, a 30% mask, validity on 2 columns) and at the
  merge of q6's 16 batch partials (16 rows: the launch and the merge
  alone).

Each prints one JSON line with the root's label, the card and the
kernels line's numbers for that shape: the event-timed ms (median of 10
calls, L2 flushed before each), the device ms of the kernel's ops in a
profiler trace, the plain version's and the library call's ms and the
bound (``masked_multi_reduce`` prints its sector floor on a line of its
own).  It checks nothing; ``chip_smoke.py`` holds the kernels against
their plain versions.  Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import chip_smoke as cs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    from spark_rapids_tpu_torch.ops import kernels as K
    if Path(K.__file__).resolve().parents[2] != root:
        print(f"time_kernels: imported {K.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    K.library()
    device = torch.device("cuda:0")
    timer = cs.Timer(torch, device)
    hbm = cs.hbm_rate(torch.cuda.get_device_name(0))
    label = args.label or str(root)

    def emit(kernel, t):
        print(json.dumps({"label": label, "card": card, "kernel": kernel,
                          **t}), flush=True)

    lo, hi = cs.split_lanes(torch, cs.group_by_codes(), device)
    live = torch.ones(cs.HASH_ROWS, dtype=torch.bool, device=device)
    emit("hash_insert", cs.time_insert(torch, K, timer, lo, hi, live,
                                       cs.HASH_SLOTS, hbm, "hash group-by"))
    del lo, hi, live
    (blo, bhi), (plo, phi) = cs.join_lanes(torch, device)
    blive = torch.ones(cs.DIM_ROWS, dtype=torch.bool, device=device)
    emit("hash_insert", cs.time_insert(torch, K, timer, blo, bhi, blive,
                                       cs.JOIN_SLOTS, hbm, "join build"))
    emit("hash_probe", cs.time_probe(torch, K, timer, blo, bhi, plo, phi,
                                     cs.JOIN_SLOTS, hbm,
                                     "fact-dim probe batch"))
    del blo, bhi, blive, plo, phi
    data = cs.gen_host(cs.Q6_ROWS)
    for n, shape in ((cs.BATCH_ROWS, "q6 batch"),
                     (cs.Q6_ROWS // cs.NSHARDS, "sharded q6 shard")):
        v, m = cs.q6_batch(torch, device, data, n)
        emit("masked_multi_reduce",
             cs.time_mmr(torch, K, timer, [v], [None], m, hbm, shape))
        del v, m
    del data
    emit("masked_multi_reduce",
         cs.time_mmr(torch, K, timer, *cs.mmr_dense(torch, device), hbm,
                     "dense"))
    emit("masked_multi_reduce",
         cs.time_mmr(torch, K, timer, *cs.q6_merge(torch, device), hbm,
                     "q6 merge"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
