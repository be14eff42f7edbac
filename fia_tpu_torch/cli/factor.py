"""Offline factor-bank builder, the ``precomputed`` solver's artifact
(port of ``fia_tpu/cli/factor.py``).

Selects the hot (user, item) pairs from the trained model's interaction
index, computes their damped block Hessians with the flat program's
``hessian`` stage, factorizes them (batched Cholesky, a clamped
eigendecomposition inverse where that fails, optional Newton–Schulz
polish) and publishes the bank through the artifact integrity layer under
the engine's canonical path (``<train_dir>/factor/<model>-bank.npz``). A
``solver="precomputed"`` engine over the same ``train_dir`` then answers
banked queries from it, and every other query through the solver ladder.
The bank's layout and fingerprint are the reference's: a bank either
package publishes loads in the other.

Run on the card (the default) or with ``--backend cpu``:

    python -m fia_tpu_torch.cli.factor --dataset synthetic --model MF \\
        --num_steps_train 300 --bank_entries 256 --train_dir /tmp/factor

Prints one JSON line: the path, entry count, Cholesky and inverse kinds,
block width. ``--verify`` (the reference serves a smoke stream against
the bank) waits for the serving port and raises (ROADMAP Queue A.11).
"""

from __future__ import annotations

import json

import numpy as np

from fia_tpu_torch.cli import common
from fia_tpu_torch.influence import factor as fbank
from fia_tpu_torch.influence.engine import InfluenceEngine


def add_factor_flags(p):
    p.add_argument("--bank_entries", type=int, default=1024,
                   help="max (user, item) pairs to precompute")
    p.add_argument("--bank_top_users", type=int, default=64,
                   help="user head size for hot-pair selection")
    p.add_argument("--bank_top_items", type=int, default=64,
                   help="item head size for hot-pair selection")
    p.add_argument("--bank_batch", type=int, default=512,
                   help="pairs per fused Hessian dispatch")
    p.add_argument("--schulz_polish", type=int, default=0,
                   help="1: Newton-Schulz refine the eigendecomposition "
                        "fallback inverses (HyperINF-style)")
    p.add_argument("--verify", action="store_true",
                   help="serve a smoke stream against the bank (not "
                        "ported yet: ROADMAP Queue A.11)")
    return p


def build_engine(args):
    """Model, trained params and a direct engine from the shared CLI
    plumbing (the builder needs the ``hessian`` stage, not a serving
    solver)."""
    common.apply_backend(args)
    splits = common.load_splits(args)
    model, params = common.build_model(args, splits)
    name = common.model_name_for(args, splits=splits)
    common.mesh_for(args)  # --mesh raises (ROADMAP Queue A.13)
    _, state, _ = common.train_or_load(args, model, params, splits,
                                       verbose=False)
    kwargs = common.engine_kwargs(args)
    kwargs["solver"] = "direct"
    engine = InfluenceEngine(model, state.params, splits["train"],
                             cache_dir=args.train_dir, model_name=name,
                             **kwargs)
    return engine, splits, name


def build_and_publish(engine, args, name) -> dict:
    pairs = fbank.select_hot_pairs(
        engine.index, max_entries=args.bank_entries,
        top_users=args.bank_top_users, top_items=args.bank_top_items,
    )
    bank = fbank.build_bank(engine, pairs, batch_queries=args.bank_batch,
                            schulz_polish=bool(args.schulz_polish))
    path = engine.factor_bank_path()
    fp = fbank.bank_fingerprint(name, engine.model.block_size,
                                engine.damping, *engine._train_host)
    fbank.publish_bank(bank, path, fp)
    return {
        "event": "factor.publish",
        "path": path,
        "entries": len(bank),
        "cholesky": int(np.count_nonzero(bank.kind == fbank.KIND_CHOLESKY)),
        "inverse": int(np.count_nonzero(bank.kind == fbank.KIND_INVERSE)),
        "block_d": bank.block_d,
    }


def main(argv=None) -> int:
    p = add_factor_flags(common.base_parser(__doc__))
    args = p.parse_args(argv)
    if args.verify:
        raise NotImplementedError(
            "not ported yet — --verify serves a stream: ROADMAP Queue A.11")
    engine, _splits, name = build_engine(args)
    print(json.dumps(build_and_publish(engine, args, name)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
