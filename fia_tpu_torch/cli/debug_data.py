"""Data-debugging driver: reverse sweep → plan → fidelity gate → apply
(port of ``fia_tpu/cli/debug_data.py``: the same flags, artifacts and
``--json_out`` keys).

The audit subsystem's end-to-end CLI. One run:

1. trains (or restores) a model, optionally planting label corruption
   first so there are genuinely harmful rows to find;
2. runs the batched reverse top-k sweep (:mod:`fia_tpu_torch.audit.reverse`)
   over the audited test set — journaled, resumable with ``--resume``;
3. builds a removal/reweighting :class:`UnlearnPlan` and publishes it
   as a checksummed artifact;
4. verifies the plan's predicted deltas against real leave-rows-out
   retraining (:mod:`fia_tpu_torch.audit.verify`) and holds them to the
   fidelity gate (sign agreement AND Spearman ≥ ``--gate``);
5. with ``--apply 1``, flows the plan live through the epoch-fenced
   unlearning loop (refused if the gate failed, unless ``--force_apply``).

``--gate_demo`` presets the reference's committed-recipe configuration
(a small planted-corruption synthetic problem):

    python -m fia_tpu_torch.cli.debug_data --gate_demo

Plain runs compose with every shared knob, e.g.::

    python -m fia_tpu_torch.cli.debug_data --dataset synthetic \
        --num_steps_train 3000 --topk 64 --plan_action reweight \
        --reweight 0.3 --verify 0 --apply 1

Everything runs on the CUDA device (raising without one) unless
``--backend cpu`` is given; ``--mesh N`` runs over a ``data`` mesh of N
slots.
"""

from __future__ import annotations

import os

import numpy as np

from fia_tpu_torch.cli import common
from fia_tpu_torch.reliability import policy as rpolicy
from fia_tpu_torch.reliability.journal import Journal
from fia_tpu_torch.utils import io


def add_audit_args(p):
    """The audit-specific knobs, on top of ``common.base_parser``."""
    p.add_argument("--topk", type=int, default=32,
                   help="reverse-sweep candidate rows to rank")
    p.add_argument("--audit_points", type=int, default=0,
                   help="audited test points sampled from the test "
                        "split (0 = the whole split)")
    p.add_argument("--chunk_points", type=int, default=0,
                   help="outer sweep chunking (throughput knob; the "
                        "result is bitwise identical for any value)")
    p.add_argument("--plan_action", choices=["remove", "reweight"],
                   default="remove")
    p.add_argument("--plan_rows", type=int, default=8,
                   help="cap on rows in the plan (after the "
                        "negative-influence filter)")
    p.add_argument("--reweight", type=float, default=0.5,
                   help="label weight w for --plan_action reweight")
    p.add_argument("--verify", type=int, default=1,
                   help="1: retrain-and-compare the plan against the "
                        "fidelity gate before anything is applied")
    p.add_argument("--verify_steps", type=int, default=3000,
                   help="gentle retraining steps per verify lane")
    p.add_argument("--verify_lr", type=float, default=1e-3)
    p.add_argument("--controls", type=int, default=-1,
                   help="most-POSITIVE sweep rows appended to the "
                        "verified slice as spread controls "
                        "(-1 = match the plan slice)")
    p.add_argument("--gate", type=float, default=0.9,
                   help="fidelity threshold for sign agreement AND "
                        "Spearman")
    p.add_argument("--apply", type=int, default=0,
                   help="1: apply the plan live through the epoch-"
                        "fenced unlearning loop")
    p.add_argument("--apply_steps", type=int, default=100,
                   help="fine-tune steps inside the fenced apply")
    p.add_argument("--force_apply", action="store_true",
                   help="apply even when the fidelity gate failed")
    p.add_argument("--corrupt_rows", type=int, default=0,
                   help="plant label corruption (y -> 6-y) on this "
                        "many off-center train rows before training — "
                        "the data-debugging demo the sweep should "
                        "catch")
    p.add_argument("--corrupt_seed", type=int, default=7)
    p.add_argument("--split_seed", type=int, default=None,
                   help="synthetic split seed when it must differ from "
                        "the model seed (default: --seed)")
    p.add_argument("--json_out", type=str, default="",
                   help="write the run summary as JSON here")
    p.add_argument("--gate_demo", action="store_true",
                   help="preset the committed fidelity-gate recipe "
                        "(see module doc)")
    return p


def apply_gate_demo(args) -> None:
    """The committed-recipe preset: a planted-corruption problem small
    enough for CPU where the gate passes (the reference's artifact in
    ``output/`` was produced by exactly this configuration)."""
    args.dataset = "synthetic"
    args.synth_stream = "zipf"
    args.synth_users, args.synth_items = 60, 40
    args.synth_train, args.synth_test = 2000, 50
    args.split_seed, args.seed = 3, 0
    args.model, args.embed_size = "MF", 4
    args.weight_decay, args.damping = 1e-3, 1e-3
    args.lr, args.batch_size = 1e-2, 200
    args.num_steps_train = 1500
    args.solver = "direct"
    args.corrupt_rows, args.corrupt_seed = 80, 7
    args.topk = 32
    args.audit_points = 0
    args.plan_action, args.plan_rows = "remove", 8
    args.verify, args.controls = 1, 8
    args.verify_steps, args.verify_lr = 3000, 1e-3
    args.retrain_times = 3


def plant_corruption(splits, n: int, seed: int) -> np.ndarray:
    """Invert ``n`` off-center train labels (y -> 6-y) in place.

    Only rows with ``|y - 3| >= 1`` are eligible: inverting a
    mid-scale rating barely moves it, and the demo needs rows that
    genuinely hurt the test set so the sweep has something real to
    find."""
    from fia_tpu_torch.data.dataset import RatingDataset

    train = splits["train"]
    y = np.array(train.y, np.float32, copy=True)
    eligible = np.flatnonzero(np.abs(y - 3.0) >= 1.0)
    if len(eligible) < n:
        raise SystemExit(
            f"--corrupt_rows {n}: only {len(eligible)} off-center rows"
        )
    rng = np.random.default_rng(seed)
    rows = np.sort(rng.choice(eligible, size=n, replace=False))
    y[rows] = 6.0 - y[rows]
    splits["train"] = RatingDataset(np.asarray(train.x), y)
    return rows


def load_splits(args):
    """``common.load_splits`` with the split seed decoupled from the
    model seed (the gate recipe plants corruption on a seed-3 stream
    but trains a seed-0 model)."""
    if args.split_seed is None:
        return common.load_splits(args)
    saved = args.seed
    args.seed = args.split_seed
    try:
        return common.load_splits(args)
    finally:
        args.seed = saved


def build_fia_model(args, splits, corrupt_tag: str):
    """The api-level :class:`FIAModel` (the audit subsystem operates on
    the full model wrapper: engine + fenced apply + event routing)."""
    from fia_tpu_torch.api import FIAModel

    num_users = max(int(np.max(s.x[:, 0])) + 1 for s in splits.values())
    num_items = max(int(np.max(s.x[:, 1])) + 1 for s in splits.values())
    name = common.model_name_for(args, splits=splits) + corrupt_tag
    return FIAModel(
        args.model, num_users, num_items, args.embed_size,
        args.weight_decay,
        batch_size=common.batch_size_for(args, splits["train"]),
        data_sets=splits, initial_learning_rate=args.lr,
        damping=args.damping, avextol=args.avextol,
        train_dir=args.train_dir, model_name=name,
        solver=args.solver, seed=args.seed, mesh=common.mesh_for(args),
        device=args.backend,
    )


def main(argv=None):
    args = add_audit_args(common.base_parser(__doc__)).parse_args(argv)
    if args.gate_demo:
        apply_gate_demo(args)
    common.apply_backend(args)

    from fia_tpu_torch.audit import build_plan, save_plan
    from fia_tpu_torch.audit.reverse import reverse_topk, sweep_fingerprint
    from fia_tpu_torch.audit.verify import verify_fingerprint, verify_plan

    splits = load_splits(args)
    corrupt_tag = ""
    planted = np.zeros(0, np.int64)
    if args.corrupt_rows:
        planted = plant_corruption(splits, args.corrupt_rows,
                                   args.corrupt_seed)
        # corruption changes the train stream: its own checkpoint/
        # artifact namespace, or a clean run would restore a corrupted
        # model (and vice versa)
        corrupt_tag = f"_corrupt{args.corrupt_rows}s{args.corrupt_seed}"

    model = build_fia_model(args, splits, corrupt_tag)
    log = common.event_log_for(args, "debug_data")
    log.log("run_start", driver="debug_data", **{
        k: v for k, v in vars(args).items() if not k.startswith("_")
    })

    from fia_tpu_torch.train import checkpoint

    steps = args.num_steps_train
    restore = (steps - 1 if args.load_checkpoint
               and checkpoint.exists(model._checkpoint_path(steps - 1))
               else 0)
    model.train(steps, save_checkpoints=True, verbose=False,
                load_checkpoints=restore)
    print(f"model {model.model_name} @ step {int(model.state.step)} "
          f"(train rows {model.num_train_examples})")

    test = splits["test"]
    if args.audit_points and args.audit_points < test.num_examples:
        sel = np.sort(np.random.default_rng(args.seed).choice(
            test.num_examples, size=args.audit_points, replace=False))
    else:
        sel = np.arange(test.num_examples)
    tp = np.asarray(test.x, np.int64)[sel]
    ty = np.asarray(test.y, np.float32)[sel]

    engine = model.engine(args.solver)
    deadline = rpolicy.Deadline(args.deadline)
    chunk_points = args.chunk_points or None
    batch_queries = args.query_batch or 256
    jpath = os.path.join(
        args.train_dir, f".debug-data-{model.model_name}.journal.jsonl")
    fp = sweep_fingerprint(engine, tp, ty, k=args.topk,
                           batch_queries=batch_queries,
                           chunk_points=chunk_points)
    with Journal.open(jpath, fp, resume=args.resume) as journal:
        sweep = reverse_topk(
            model, tp, ty, k=args.topk, engine=engine,
            batch_queries=batch_queries, chunk_points=chunk_points,
            journal=journal, deadline=deadline,
        )
    print(f"sweep {sweep.sweep_id}: {sweep.rows_scored} row-scores in "
          f"{sweep.seconds:.1f}s ({sweep.rows_per_s:,.0f} rows/s)")
    if len(planted):
        hits = np.isin(sweep.row_ids, planted)
        print(f"planted-corruption hit rate: {hits.mean():.2f} "
              f"({int(hits.sum())}/{len(hits)} of top-{len(hits)} "
              f"are planted rows)")

    plan = build_plan(model, sweep, action=args.plan_action,
                      max_rows=args.plan_rows, reweight=args.reweight)
    plan_path = os.path.join(
        args.train_dir, f"{model.model_name}-plan-{plan.plan_id}.npz")
    save_plan(plan, plan_path)
    print(f"plan {plan.plan_id} [{plan.action}]: {plan.rows} rows, "
          f"predicted test-SSE delta {plan.predicted_delta:+.4f} "
          f"-> {plan_path}")

    summary = {
        "model_key": model.model_name, "sweep_id": sweep.sweep_id,
        "rows_scored": int(sweep.rows_scored),
        "rows_per_s": round(sweep.rows_per_s, 1),
        "plan_id": plan.plan_id, "plan_action": plan.action,
        "plan_rows": int(plan.rows),
        "predicted_delta": float(plan.predicted_delta),
        "planted_hit_rate": (float(np.isin(sweep.row_ids, planted).mean())
                             if len(planted) else None),
        "plan_path": plan_path,
    }

    verdict = None
    if args.verify:
        n_ctl = args.plan_rows if args.controls < 0 else args.controls
        control_rows = control_deltas = None
        if n_ctl:
            # spread controls: the sweep's most-positive rows (verify.py
            # module doc) — value-descending with row-id ascending on
            # ties, deterministic like the sweep itself
            g = sweep.group_scores
            order = np.argsort(-g.astype(np.float64), kind="stable")
            control_rows = order[:n_ctl].astype(np.int64)
            control_deltas = g[control_rows].astype(np.float64)
        vfp = verify_fingerprint(
            model, plan, tp, num_steps=args.verify_steps,
            batch_size=common.batch_size_for(args, splits["train"]),
            learning_rate=args.verify_lr,
            retrain_times=args.retrain_times, seed=args.seed,
            max_rows=args.plan_rows, control_rows=control_rows,
        )
        vjpath = os.path.join(
            args.train_dir,
            f".debug-data-verify-{plan.plan_id}.journal.jsonl")
        vart = os.path.join(
            args.train_dir, f"{model.model_name}-verify-{plan.plan_id}.npz")
        with Journal.open(vjpath, vfp, resume=args.resume) as vj:
            verdict = verify_plan(
                model, plan, tp, ty, num_steps=args.verify_steps,
                batch_size=common.batch_size_for(args, splits["train"]),
                learning_rate=args.verify_lr,
                retrain_times=args.retrain_times,
                lane_chunk=args.lane_chunk, max_rows=args.plan_rows,
                seed=args.seed, control_rows=control_rows,
                control_deltas=control_deltas, gate=args.gate,
                journal=vj, artifact_path=vart, mesh=model.mesh,
            )
        state = "PASS" if verdict.passed else "FAIL"
        print(f"fidelity gate [{state}]: sign agreement "
              f"{verdict.sign_agreement:.3f}, spearman "
              f"{verdict.spearman:.3f} (gate {args.gate:g}, "
              f"{verdict.plan_rows} plan rows + "
              f"{len(verdict.row_ids) - verdict.plan_rows} controls) "
              f"-> {vart}")
        log.log("fidelity_gate", passed=verdict.passed,
                sign_agreement=float(verdict.sign_agreement),
                spearman=float(verdict.spearman), gate=float(args.gate))
        summary.update(
            gate_passed=bool(verdict.passed),
            sign_agreement=float(verdict.sign_agreement),
            spearman=float(verdict.spearman),
            verify_artifact=vart,
        )

    if args.apply:
        if verdict is not None and not verdict.passed \
                and not args.force_apply:
            print("apply refused: fidelity gate failed "
                  "(--force_apply overrides)")
            summary["apply_status"] = "refused"
        else:
            from fia_tpu_torch.audit import apply_plan

            res = apply_plan(model, plan, steps=args.apply_steps)
            print(f"apply [{res.status}]: {plan.rows} rows "
                  f"{plan.action} in {res.seconds:.1f}s "
                  f"(touched {res.touched_users} users / "
                  f"{res.touched_items} items)"
                  + (f" reason={res.reason}" if res.reason else ""))
            summary["apply_status"] = res.status
            summary["apply_seconds"] = round(res.seconds, 3)

    log.log("run_done", **{k: v for k, v in summary.items()
                           if not isinstance(v, np.ndarray)})
    log.close()
    if args.json_out:
        io.save_json_atomic(args.json_out,
                            dict(sorted(summary.items())), indent=2)
        print(f"summary -> {args.json_out}")
    return summary


if __name__ == "__main__":
    main()
