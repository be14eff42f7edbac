"""Time ``segment_hessian`` at other piece sizes than ``piece_rows(d)``'s.

    python3 segment_piece_sweep.py [--bases 128 256 512]

On one CUDA card: builds the kernel from the checkout, makes the flat
path's Hessian operands of MF and NCF (k = 16, d = 34 / 64) at ML-1M
shape for 256 and 1024 held-out queries, with seeded weights as
``chip_smoke.py``'s main path does, and times the kernel's two launches
by CUDA-graph replay with pieces of ``base`` rows times the block's
tile pairs, each base in turn, forward and then reversed. Prints the
card's name and power limit, then one JSON object: ms by model, batch
size and base. The engine always runs ``piece_rows(d)``
(``PIECE_ROWS_BASE`` rows a tile pair); another piece size changes the
order of the sums, and so their bits, which is why only this
measurement launches one.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

import chip_smoke as cs
from fia_tpu_torch.influence.kernels import common
from fia_tpu_torch.influence.kernels import segment as kseg


def launch(g, wv, abe, off, piece: int):
    """The kernel's two launches on ``segment_sums``' operands, in pieces
    of ``piece`` rows from each segment's start."""
    S, d = g.shape
    T = off.shape[0] - 1
    HH = torch.empty((T, d, d), dtype=torch.float32, device=g.device)
    sabe = torch.empty((T,), dtype=torch.float32, device=g.device)
    slots = kseg.scratch_slots(S, piece)
    part = torch.empty((slots, d, d), dtype=torch.float32, device=g.device)
    part_abe = torch.empty((slots,), dtype=torch.float32, device=g.device)
    fn = common.load_function("segment_hessian", "fia_segment_hessian",
                              kseg._ARGTYPES)
    rc = fn(g.data_ptr(), wv.data_ptr(), abe.data_ptr(), off.data_ptr(),
            HH.data_ptr(), sabe.data_ptr(), part.data_ptr(),
            part_abe.data_ptr(), S, T, d, piece,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_hessian launch failed: cudaError {rc}")
    return HH, sabe


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bases", type=int, nargs="+", default=[128, 256, 512],
                    help="rows a piece for each 64 x 64 tile pair")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("segment_piece_sweep: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    common.build(["segment_hessian"])
    train = cs.synthesize_ratings(cs.USERS, cs.ITEMS, cs.ROWS, seed=0)
    pts = cs.sample_heldout_pairs(train.x, cs.USERS, cs.ITEMS,
                                  max(cs.BATCHES), seed=17)
    out = {}
    for family, cls in (("mf", cs.MF), ("ncf", cs.NCF)):
        eng, _ = cs.setup_engines(cls(cs.USERS, cs.ITEMS, cs.K_EMB, cs.WD),
                                  train)
        for T in cs.BATCHES:
            g, _, wv, abe, off = cs.segment_operands(eng, pts, T)
            pairs = kseg.piece_rows(g.shape[1]) // kseg.PIECE_ROWS_BASE
            times = {}
            for base in (*args.bases, *reversed(args.bases)):
                times.setdefault(str(base), []).append(cs.graph_ms(
                    lambda: launch(g, wv, abe, off, base * pairs), iters=20))
            out[f"{family} T={T}"] = times
            print(f"{family} T={T} d={g.shape[1]}: {json.dumps(times)}",
                  file=sys.stderr, flush=True)
        del eng
        torch.cuda.empty_cache()
    print(json.dumps({"segment_piece_sweep_ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
