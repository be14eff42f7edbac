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
block width. ``--verify`` additionally serves a small stream against the
published bank in-process and exits non-zero unless (a) the bank loaded,
(b) the hits over banked pairs are positive with scores at Spearman
>= 0.999 against the direct solver, and (c) a miss falls through bitwise
as a bank-less engine at the next rung answers it; its summary (worst
Spearman among them) rides the JSON line under ``verify``.
"""

from __future__ import annotations

import json
import sys

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
                   help="after publishing, serve a smoke stream against "
                        "the bank in-process; nonzero exit on any "
                        "accuracy/fall-through failure")
    return p


def build_engine(args):
    """Model, trained params and a direct engine from the shared CLI
    plumbing (the builder needs the ``hessian`` stage, not a serving
    solver)."""
    common.apply_backend(args)
    splits = common.load_splits(args)
    model, params = common.build_model(args, splits)
    name = common.model_name_for(args, splits=splits)
    mesh = common.mesh_for(args)
    _, state, _ = common.train_or_load(args, model, params, splits,
                                       verbose=False)
    kwargs = common.engine_kwargs(args)
    kwargs["solver"] = "direct"
    engine = InfluenceEngine(model, state.params, splits["train"],
                             cache_dir=args.train_dir, model_name=name,
                             mesh=mesh, **kwargs)
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


def run_verify(engine, args, name, summary) -> int:
    """In-process smoke against the just-published bank, on the
    builder's device."""
    from fia_tpu_torch.data.dataset import RatingDataset
    from fia_tpu_torch.eval.metrics import spearman
    from fia_tpu_torch.reliability import policy as rpolicy

    train_host = engine._train_host
    train = RatingDataset(*train_host)

    def mk(solver, cache):
        return InfluenceEngine(
            engine.model, engine.full_params(), train,
            damping=engine.damping,
            solver=solver, cache_dir=args.train_dir if cache else None,
            model_name=name, lissa_depth=min(engine.lissa_depth, 200),
            device=engine.device,
        )

    eng = mk("precomputed", cache=True)
    failures = []
    n_loaded = eng.ensure_factor_bank()
    if n_loaded <= 0:
        failures.append("published bank failed verified load")
    else:
        pairs = np.asarray(eng._bank.pairs[: min(16, n_loaded)], np.int64)
        res = eng.query_batch(pairs)
        st = eng.bank_stats()
        if st["hits"] <= 0:
            failures.append("no bank hits over banked pairs")
        res_ref = mk("direct", cache=False).query_batch(pairs)
        worst = 1.0
        for t in range(len(pairs)):
            a, b = res.scores_of(t), res_ref.scores_of(t)
            if len(a) > 1 and (np.std(a) > 0 or np.std(b) > 0):
                worst = min(worst, spearman(a, b))
        if not (worst >= 0.999):
            failures.append(f"hit-path Spearman vs direct {worst} < 0.999")
        # miss fall-through: a pair outside the bank must answer
        # bitwise-identically to a bank-less engine on the same ladder
        banked = {tuple(p) for p in eng._bank.pairs.tolist()}
        x = train_host[0]
        miss = next(
            ((int(u), int(i)) for u, i in zip(x[:, 0], x[:, 1])
             if (int(u), int(i)) not in banked),
            None,
        )
        if miss is not None:
            mq = np.asarray([miss], np.int64)
            a = eng.query_batch(mq).scores_of(0)
            b = mk(rpolicy.next_solver("precomputed") or "direct",
                   cache=False).query_batch(mq).scores_of(0)
            if not np.array_equal(a, b):
                failures.append("miss fall-through not bitwise-identical "
                                "to the bank-less ladder")
        else:
            failures.append("no miss pair available to check fall-through")
        summary["verify"] = {
            "loaded": n_loaded, "spearman_worst": worst,
            **{k: st[k] for k in ("hits", "misses", "dropped_stale")},
        }
    for f in failures:
        print(f"FACTOR VERIFY FAIL: {f}", file=sys.stderr)
    if not failures:
        print(f"factor verify ok: {n_loaded} entries, "
              f"hits {summary['verify']['hits']}, "
              f"worst Spearman {summary['verify']['spearman_worst']:.6f}")
    return 1 if failures else 0


def main(argv=None) -> int:
    p = add_factor_flags(common.base_parser(__doc__))
    args = p.parse_args(argv)
    engine, _splits, name = build_engine(args)
    summary = build_and_publish(engine, args, name)
    rc = 0
    if args.verify:
        rc = run_verify(engine, args, name, summary)
    print(json.dumps(summary))
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
