"""RQ1 driver: influence-vs-retraining fidelity (port of
``fia_tpu/cli/rq1.py``).

Equivalent of reference ``src/scripts/RQ1.py`` (+ ``RQ1.sh``). Outputs
the same artifact, ``<train_dir>/RQ1-<model>-<dataset>.npz`` with the
same keys and divert rules, resumes through the same journal, and
prints the Pearson correlation. Runs on the CUDA device (``--backend
cpu`` for the CPU).

Run:  python -m fia_tpu_torch.cli.rq1 --dataset synthetic --model MF \
        --num_steps_train 3000 --num_steps_retrain 1500 --num_test 2 \
        --train_dir /tmp/rq1-smoke
"""

from __future__ import annotations

import os

import numpy as np

from fia_tpu_torch.cli import common
from fia_tpu_torch.reliability import policy as rpolicy
from fia_tpu_torch.reliability.artifacts import publish_npz
from fia_tpu_torch.reliability.journal import Journal


def artifact_path(train_dir, model, dataset, args, test_indices, tag,
                  model_key=""):
    """Where this run banks its npz rows.

    The canonical reference-shaped name is RQ1-<model>-<dataset>.npz.
    Two divert rules keep hours of banked chip time safe from
    clobbering:

    - ``--test_indices`` resume runs always divert to a -pt<ids>
      suffix (merged by the reference's scripts/merge_rq1.py); an occupied -pt path
      banked under a different protocol/config ladders further to
      -pt<ids>-<protocol>[-m<digest>] instead of clobbering.
    - Any other run that finds an existing artifact written under a
      DIFFERENT protocol, train stream, or model config diverts to a
      protocol-suffixed name. "Same protocol" covers the retrain
      budget, removals, num_test, maxinf, seed, stream tag (stored in
      the npz) AND a model_key folding in the
      training hyperparameters (num_steps_train, lr, embed_size,
      damping, weight_decay via common.model_name_for) — runs
      differing only in those used to compare equal and overwrite the
      canonical artifact in place despite measuring different
      influence values. Same-protocol re-runs still overwrite in
      place, which is what makes chain retries idempotent. Artifacts
      predating any provenance field are treated as different
      (divert).
    """
    proto = (args.num_steps_retrain, args.retrain_times,
             args.num_to_remove, args.num_test, int(args.maxinf),
             args.seed, tag or "")

    def occupied_by_other(path):
        """True when ``path`` exists and was banked by a run with a
        different protocol, stream, or model config (or predates the
        provenance fields — treated as different, never clobbered)."""
        if not os.path.exists(path):
            return False
        try:
            with np.load(path, allow_pickle=False) as z:
                old = tuple(z["protocol"]) + (str(z["stream_tag"]),)
                old_key = (str(z["model_key"]) if "model_key" in z.files
                           else None)
        except Exception:
            return True
        return not (old == (*(int(x) for x in proto[:6]), proto[6])
                    and old_key == model_key)

    pstr = (f"{'' if not proto[6] else proto[6] + '-'}"
            f"r{proto[0]}x{proto[1]}n{proto[3]}rm{proto[2]}"
            + (f"-maxinf" if proto[4] else "")
            + (f"-seed{proto[5]}" if proto[5] else ""))

    def digested(path):
        """Last rung of the divert ladder: suffix the model_key digest.

        The digested path is checked for occupancy too — it is 8 hex
        chars of sha1(model_key), so two different model configs CAN
        collide there. A collision means every rung of the ladder is
        occupied by some other run; clobbering silently at the bottom
        rung would be exactly the artifact-loss bug class the ladder
        exists to prevent, so fail loudly instead.
        """
        import hashlib

        digest = hashlib.sha1(model_key.encode()).hexdigest()[:8]
        dpath = path[: -len(".npz")] + f"-m{digest}.npz"
        if occupied_by_other(dpath):
            raise SystemExit(
                f"artifact ladder exhausted: {dpath} is already banked "
                f"by a different run (model_key digest collision at "
                f"m{digest}). Refusing to clobber hours of banked rows "
                "— move the existing artifact aside or change "
                "--train_dir."
            )
        return dpath

    canonical = os.path.join(train_dir, f"RQ1-{model}-{dataset}.npz")
    if args.test_indices:
        # resume runs never claim the canonical name; their -pt path
        # gets the same occupied-by-other laddering as any divert
        # (two resumes at the same indices but different retrain
        # protocol or training config must not clobber each other)
        suffix = "-".join(str(int(t)) for t in test_indices)
        pt = os.path.join(train_dir, f"RQ1-{model}-{dataset}-pt{suffix}.npz")
        if not occupied_by_other(pt):
            return pt
        ptp = pt[: -len(".npz")] + f"-{pstr}.npz"
        return ptp if not occupied_by_other(ptp) else digested(ptp)
    if not os.path.exists(canonical) or not occupied_by_other(canonical):
        return canonical
    divert = os.path.join(train_dir, f"RQ1-{model}-{dataset}-{pstr}.npz")
    # the divert name encodes the retrain protocol but not the model
    # config; two same-protocol runs differing only in training
    # hyperparameters would compute the SAME divert path
    return divert if not occupied_by_other(divert) else digested(divert)


def main(argv=None):
    args = common.base_parser(__doc__).parse_args(argv)
    common.apply_backend(args)

    from fia_tpu_torch.eval.metrics import pearson, spearman
    from fia_tpu_torch.eval.rq1 import test_retraining
    from fia_tpu_torch.influence.engine import InfluenceEngine

    splits = common.load_splits(args)
    train, test = splits["train"], splits["test"]
    model, params = common.build_model(args, splits)
    print(f"users={model.num_users} items={model.num_items} "
          f"train={train.num_examples} test={test.num_examples} "
          f"params={model.num_params()}")

    common.mesh_for(args)  # --mesh raises (ROADMAP Queue A.13)
    log = common.event_log_for(args, "rq1")
    log.log("run_start", driver="rq1", **{
        k: v for k, v in vars(args).items() if not k.startswith("_")
    })
    trainer, state, batch = common.train_or_load(
        args, model, params, splits, event_log=log
    )

    engine = InfluenceEngine(
        model, state.params, train,
        cache_dir=args.train_dir,
        model_name=common.model_name_for(args, splits=splits),
        **common.engine_kwargs(args),
    )
    test_indices = common.pick_test_points(args, splits, engine.index)
    print(f"test indices: {list(map(int, test_indices))}")

    # Never clobber a banked artifact from a different run: resume
    # runs and different-protocol/stream runs divert to suffixed
    # paths; only same-protocol re-runs overwrite (idempotent chain
    # retries). See artifact_path.
    tag = common.synth_tag_for(args, splits)
    # model_key folds the training hyperparameters into provenance;
    # lr/num_steps_train are not in model_name_for's checkpoint key, so
    # append them explicitly (two runs differing only in training config
    # must not overwrite each other's artifact)
    model_key = (f"{common.model_name_for(args, splits=splits)}"
                 f"_steps{args.num_steps_train}_lr{args.lr:g}")
    art_path = artifact_path(
        args.train_dir, args.model, args.dataset, args, test_indices, tag,
        model_key=model_key,
    )
    if os.path.basename(art_path) != f"RQ1-{args.model}-{args.dataset}.npz":
        print(f"existing artifact kept; rows -> {art_path}")

    # Resumable chain (fia_tpu/reliability): each completed test point is
    # journaled next to its artifact with the exact arrays the npz rows
    # are built from, so a killed chain restarted with --resume recomputes
    # ZERO completed points and emits a byte-identical npz. The journal
    # fingerprint binds the rows to this exact run (model config, retrain
    # protocol, stream, test indices) — a mismatched --resume fails loudly
    # (JournalMismatch) rather than stitching rows from a different run.
    jpath = os.path.join(
        args.train_dir,
        "." + os.path.basename(art_path)[: -len(".npz")] + ".journal.jsonl",
    )
    fingerprint = {
        "kind": "rq1-chain",
        "model_key": model_key,
        "protocol": [args.num_steps_retrain, args.retrain_times,
                     args.num_to_remove, args.num_test, int(args.maxinf),
                     args.seed],
        "stream_tag": tag or "",
        "test_indices": [int(i) for i in test_indices],
    }
    deadline = rpolicy.Deadline(args.deadline)

    actuals, predictions, removed = [], [], []
    repeat_rows, drift_rows, y0s = [], [], []

    def bank_rows():
        # per-test-point rows can be ragged (a test point's related set
        # may hold fewer than num_to_remove rows), so stack as flat
        # arrays plus per-row test-point ids rather than a (T, R) matrix.
        # repeat_y rows align with actual_loss_diffs rows; the per-point
        # drift lane and original prediction ride alongside so the
        # noise-floor decomposition (scripts/fidelity_spread.py) can run
        # from the artifact alone
        # published through the integrity layer: the npz bytes stay
        # identical to a plain savez (resume byte-identity contract),
        # and the sidecar manifest binds the rows to the same journal
        # fingerprint that guards --resume
        publish_npz(
            art_path,
            dict(
                actual_loss_diffs=np.concatenate(actuals),
                predicted_loss_diffs=np.concatenate(predictions),
                indices_to_remove=np.concatenate(removed),
                test_index_of_row=np.repeat(
                    [int(i) for i in test_indices[: len(actuals)]],
                    [len(a) for a in actuals],
                ),
                repeat_y=np.concatenate(repeat_rows),
                drift_repeat_y=np.stack(drift_rows),
                y0_of_point=np.asarray(y0s, np.float32),
                # provenance: lets artifact_path distinguish a
                # same-protocol re-run (overwrite) from a different run
                # (divert), and lets post-processing label rows
                protocol=np.asarray([args.num_steps_retrain,
                                     args.retrain_times, args.num_to_remove,
                                     args.num_test, int(args.maxinf),
                                     args.seed], np.int64),
                stream_tag=np.asarray(tag),
                model_key=np.asarray(model_key),
            ),
            fingerprint=fingerprint,
        )

    saved = False
    with Journal.open(jpath, fingerprint, resume=args.resume) as journal:
        for t in test_indices:
            point_key = f"point:{int(t)}"
            if journal.done(point_key):
                p = journal.get(point_key)
                actuals.append(p["actual_y_diffs"])
                predictions.append(p["predicted_y_diffs"])
                removed.append(p["indices_to_remove"])
                repeat_rows.append(p["per_repeat_y"][:-1])
                drift_rows.append(p["per_repeat_y"][-1])
                y0s.append(p["y0"])
                print(f"test {int(t)}: restored from journal "
                      f"(pearson r = {p['pearson']:.4f})")
                log.log("test_point_restored", test_idx=int(t),
                        pearson=float(p["pearson"]))
                continue
            # a spent wall-clock budget stops the chain cleanly BETWEEN
            # points — but never before at least one point is banked, so
            # every run makes forward progress for --resume to build on
            if deadline.expired() and actuals:
                print(f"[reliability] deadline ({args.deadline:g}s) "
                      f"reached after {len(actuals)} point(s); rerun "
                      "with --resume to continue")
                log.log("deadline_stop", points_done=len(actuals))
                break
            res = test_retraining(
                engine, train, test, int(t),
                num_to_remove=args.num_to_remove,
                num_steps=args.num_steps_retrain,
                batch_size=batch,
                learning_rate=args.lr,
                retrain_times=args.retrain_times,
                remove_type="maxinf" if args.maxinf else "random",
                lane_chunk=args.lane_chunk,
                steps_per_dispatch=args.steps_per_dispatch,
                event_log=log,
            )
            r = pearson(res.actual_y_diffs, res.predicted_y_diffs)
            print(f"test {int(t)}: pearson r = {r:.4f} "
                  f"(bias_retrain {res.bias_retrain:+.5f})")
            log.log("test_point_done", test_idx=int(t), pearson=float(r),
                    bias_retrain=float(res.bias_retrain))
            actuals.append(res.actual_y_diffs)
            predictions.append(res.predicted_y_diffs)
            removed.append(res.indices_to_remove)
            repeat_rows.append(res.per_repeat_y[:-1])
            drift_rows.append(res.per_repeat_y[-1])
            y0s.append(res.y0)

            bank_rows()
            saved = True
            # journal AFTER the npz save: a crash between the two leaves
            # the point un-journaled and it is simply recomputed (and the
            # npz idempotently rewritten) on --resume
            journal.record(point_key, {
                "actual_y_diffs": np.asarray(res.actual_y_diffs),
                "predicted_y_diffs": np.asarray(res.predicted_y_diffs),
                "indices_to_remove": np.asarray(res.indices_to_remove),
                "per_repeat_y": np.asarray(res.per_repeat_y),
                "y0": float(res.y0),
                "pearson": float(r),
                "bias_retrain": float(res.bias_retrain),
            })
    if actuals and not saved:
        # every point came from the journal (e.g. the killed run died
        # after its last point's journal append but before exit, or the
        # artifact was removed) — rewrite the npz from the restored rows
        bank_rows()

    a = np.concatenate(actuals)
    p = np.concatenate(predictions)
    print(f"Correlation is {pearson(a, p):.6f} (spearman {spearman(a, p):.6f})")
    log.log("run_done", pearson=float(pearson(a, p)),
            spearman=float(spearman(a, p)))
    log.close()
    return pearson(a, p)


if __name__ == "__main__":
    main()
