#!/usr/bin/env python3
"""Whether a (w, n) float32 panel summed over its slots (torch's
``sum(dim=0)``, the plain ELL encodings' row sums) gives the same bits when
its rows are split into blocks, on the card; and the sliced-ELL kernel's
row blocks against one launch.

    python3 scripts/split_panel_sums.py

For widths 1-300 and row counts 129-2,245,963, each split into 2, 3 and 4
blocks at multiples of 32 rows (the row split of a device mesh), prints
every case whose concatenated block sums differ from the whole panel's, and
the count; then the same for a sequential sum (``cumsum(dim=0)[-1]``) and
for the sliced-ELL kernel on a random operator split over 4 shards of the
card.  Needs an NVIDIA GPU."""

import os
import sys

import numpy as np
import scipy.sparse as sp
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def cuts(n, P):
    units = -(-n // 32)
    return [32 * (k * units // P) for k in range(P)] + [n]


def main() -> int:
    if not torch.cuda.is_available():
        print("split_panel_sums: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from shm3d_torch._device import resolve_device
    from shm3d_torch.parallel import device_mesh
    from shm3d_torch.solve import ell, pell

    dev = resolve_device("cuda")
    rng = np.random.default_rng(0)
    differ = {"sum": 0, "cumsum": 0}
    cases = 0
    for w in (1, 3, 4, 7, 13, 20, 33, 60, 100, 200, 300):
        for n in (129, 1000, 4097, 49723, 198814, 2245963):
            if w * n > 3e8:
                continue
            v = torch.as_tensor(rng.standard_normal((w, n)), dtype=torch.float32, device=dev)
            whole = {"sum": v.sum(0), "cumsum": v.cumsum(0)[-1]}
            for P in (2, 3, 4):
                b = cuts(n, P)
                blocks = [v[:, b[k]:b[k + 1]].contiguous() for k in range(P)]
                got = {"sum": torch.cat([x.sum(0) for x in blocks]),
                       "cumsum": torch.cat([x.cumsum(0)[-1] for x in blocks])}
                cases += 1
                for how in differ:
                    if not torch.equal(whole[how], got[how]):
                        differ[how] += 1
                        print(f"{how}: w={w} n={n} P={P} blocks differ")
    print(f"split panels whose sums differ: sum(dim=0) {differ['sum']} of {cases}, "
          f"cumsum(dim=0)[-1] {differ['cumsum']} of {cases} "
          f"({torch.cuda.get_device_name(0)})")
    n, m = 32 * 1001 + 13, 20000
    widths = np.minimum(rng.geometric(0.15, n) - 1, 40)
    r = np.repeat(np.arange(n), widths)
    A = sp.coo_matrix((rng.standard_normal(r.size), (r, rng.integers(0, m, r.size))),
                      shape=(n, m)).tocsr()
    host = pell.sell_from_csr(A, np.float32)
    split = ell.device_put_tree(host, dev, device_mesh(devices=[dev] * 4))
    x = torch.as_tensor(rng.standard_normal(m), dtype=torch.float32, device=dev)
    same = torch.equal(pell.apply(split, x), pell.apply(ell.device_put_tree(host, dev), x))
    print(f"sliced-ELL kernel on {split.block_rows} row blocks equal to one launch: {same}")
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
