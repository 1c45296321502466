#!/usr/bin/env python3
"""K1's self-attention outputs from two checkouts of the port, bit for bit, on one card.

    python3 scripts/k1_bits.py --root <checkout> --out <file.json>   # digests of its K1
    python3 scripts/k1_bits.py --compare <a.json> <b.json>           # exit 1 unless equal

``--root`` imports ``lidar_layout_tpu_torch`` from that checkout (its
kernels built there at first use) and runs K1 (``ops.attention._launch``,
with the log-sum-exp) on inputs drawn with numpy from fixed seeds, at the
shapes that ``chip_smoke.py`` checks K1 at (the flagship's, fused qkv
views, key padding, head dims 16 to 128, the ragged edges of a tile), in
float32 and bfloat16. It writes the SHA-256 of every output's bytes. Two
checkouts whose K1 computes the same bits at S_q == S_kv write equal files.
Needs CUDA.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np

# (B, H, S, D), q/k/v as views of one fused projection, a key-padding bias
CASES = [((16, 8, 2048, 32), False, False), ((16, 16, 512, 32), False, False),
         ((16, 32, 128, 32), False, False), ((16, 8, 2048, 32), True, False),
         ((4, 8, 1000, 32), False, True), ((2, 4, 333, 64), True, True),
         ((2, 2, 200, 128), False, True), ((2, 2, 130, 16), True, False),
         ((2, 2, 1, 32), False, False), ((2, 2, 127, 32), False, True),
         ((2, 2, 129, 32), True, False), ((1, 2, 2049, 32), False, False)]


def digests(root: str) -> dict:
    sys.path.insert(0, root)
    import torch
    from lidar_layout_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        raise SystemExit("k1_bits: needs CUDA")
    out = {"module": A.__file__}
    for i, ((b, h, s, d), fused, masked) in enumerate(CASES):
        rng = np.random.default_rng(100 + i)
        qkv = torch.tensor(rng.standard_normal((b, s, 3, h, d)), dtype=torch.float32,
                           device="cuda")
        kb = None
        if masked:
            keep = np.arange(s)[None, :] < rng.integers(1, s + 1, (b, 1))
            kb = torch.tensor(np.where(keep, 0.0, -1e9), dtype=torch.float32, device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            t = qkv.to(dtype)
            if fused:   # strided views of the fused projection
                q, k, v = (t[:, :, j].transpose(1, 2) for j in range(3))
            else:
                q, k, v = (t[:, :, j].transpose(1, 2).contiguous() for j in range(3))
            o, lse = A._launch(q, k, v, kb, with_lse=True)
            torch.cuda.synchronize()
            for name, val in (("o", o), ("lse", lse)):
                raw = val.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                out[f"{(b, h, s, d)} fused={fused} kbias={masked} {str(dtype)[6:]} {name}"] = (
                    hashlib.sha256(raw).hexdigest())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2)
    args = ap.parse_args()
    if args.compare:
        a, b = (json.load(open(p)) for p in args.compare)
        keys = [k for k in a if k != "module"]
        differ = [k for k in keys if a[k] != b.get(k)]
        print(f"k1_bits: {len(keys) - len(differ)} of {len(keys)} outputs bit-equal "
              f"({a['module']} against {b['module']})" + "".join(f"\n  differs: {k}"
                                                              for k in differ))
        return 1 if differ or set(a) != set(b) else 0
    with open(args.out, "w") as f:
        json.dump(digests(args.root), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
