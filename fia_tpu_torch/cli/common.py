"""Shared CLI plumbing for the RQ drivers (port of
``fia_tpu/cli/common.py``).

The same flags and defaults as the reference (its reference knob names,
``RQ1.py:18-34``, plus the framework's), the same checkpoint names,
fingerprints, resume and rotation, so a checkpoint one package's driver
wrote under a ``--train_dir`` loads in the other's.

What differs: ``--backend`` selects the torch device — none (the
default) runs on the CUDA device and raises without one, ``cpu`` runs
on the CPU; ``--mesh N`` lays a 1-D ``data`` mesh over the first N
slots of that backend (virtual slots, ``parallel.mesh.virtual_devices``,
when fewer devices are visible), and ``--model_parallel M`` with it a
2-D ``('data', 'model')`` mesh whose engines row-shard the embedding
tables (``parallel.sharded``). Fresh weights come from a ``torch.Generator`` seeded with
``--seed``, which cannot reproduce ``jax.random``'s draws: a run that
trains from scratch starts elsewhere than the reference's (ROADMAP
Queue C), while one that loads the reference's checkpoint starts where
it does.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from fia_tpu_torch.data.loaders import load_dataset
from fia_tpu_torch.data.synthetic import synthetic_splits
from fia_tpu_torch.device import resolve_device
from fia_tpu_torch.models import MF, NCF
from fia_tpu_torch.train import checkpoint
from fia_tpu_torch.train.trainer import Trainer, TrainConfig

MODELS = {"MF": MF, "NCF": NCF}

# Reference batch sizes: exact divisors of the train-set sizes
# (RQ1.py:68, 71).
BATCH_SIZES = {"movielens": 3020, "yelp": 3009}


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    # reference knobs (names preserved)
    p.add_argument("--avextol", type=float, default=1e-3,
                   help="solver tolerance for the influence solve")
    p.add_argument("--damping", type=float, default=1e-6)
    p.add_argument("--weight_decay", type=float, default=1e-3)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--embed_size", type=int, default=16)
    p.add_argument("--maxinf", type=int, default=1,
                   help="1: remove most-influential rows; 0: random")
    p.add_argument("--dataset", type=str, default="movielens",
                   choices=["movielens", "yelp", "synthetic"])
    p.add_argument("--model", type=str, default="MF", choices=["MF", "NCF"])
    p.add_argument("--num_test", type=int, default=5)
    p.add_argument("--test_indices", type=int, nargs="+", default=None,
                   help="explicit test-split row indices; overrides the "
                        "num_test sampler (resume a truncated run's "
                        "missing points, or probe a specific query)")
    p.add_argument("--num_steps_train", type=int, default=80_000)
    p.add_argument("--num_steps_retrain", type=int, default=24_000)
    p.add_argument("--reset_adam", type=int, default=0)
    p.add_argument("--load_checkpoint", type=int, default=1)
    p.add_argument("--retrain_times", type=int, default=4)
    p.add_argument("--num_to_remove", type=int, default=50,
                   help="training rows removed per test point for RQ1 "
                        "ground truth (experiments.py:18 default; the "
                        "reference RQ1 driver passes 1)")
    p.add_argument("--lane_chunk", type=int, default=32,
                   help="LOO retraining lanes stacked in one chunk")
    p.add_argument("--steps_per_dispatch", type=int, default=2000,
                   help="max retraining steps per device dispatch")
    p.add_argument("--sort_test_case", type=int, default=0,
                   help="1: pick the least-supported test points")
    # framework knobs
    p.add_argument("--backend", type=str, default=None,
                   choices=[None, "cuda", "cpu"],
                   help="torch device (default: the CUDA device, raising "
                        "without one; 'cpu' runs on the CPU)")
    p.add_argument("--solver", type=str, default="direct",
                   choices=["direct", "cg", "lissa", "schulz",
                            "precomputed", "sampled"])
    p.add_argument("--sampled_cap", type=int, default=None,
                   help="sampled-rung Hessian sample cap per query "
                        "(docs/design.md §22; default: the engine's "
                        "DEFAULT_CAP). Queries with fewer related rows "
                        "are exact (err_bound 0)")
    p.add_argument("--sampled_tol", type=float, default=None,
                   help="sampled-rung certificate tolerance: queries "
                        "whose err_bound exceeds it escalate one ladder "
                        "rung (default: inf — always serve sampled)")
    p.add_argument("--cg_maxiter", type=int, default=100,
                   help="CG iteration cap (reference fmin_ncg maxiter, "
                        "matrix_factorization.py:431)")
    p.add_argument("--lissa_depth", type=int, default=10_000,
                   help="LiSSA recursion depth (reference default, "
                        "genericNeuralNet.py:544)")
    p.add_argument("--lissa_scale", type=float, default=10.0,
                   help="LiSSA scale (reference genericNeuralNet.py:511)")
    p.add_argument("--impl", type=str, default="auto",
                   choices=["auto", "flat", "padded"],
                   help="query implementation: flat segment-sum or "
                        "padded per-query vmap")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard query batches, training and LOO retraining "
                        "over an N-device 'data' mesh (0 = single device)")
    p.add_argument("--model_parallel", type=int, default=1,
                   help="row-shard the embedding tables over a 'model' "
                        "mesh axis of this size (must divide --mesh; 1 = "
                        "replicated tables). >1 builds a 2-D "
                        "('data','model') mesh and turns on the engine's "
                        "shard_tables placement — for tables too large "
                        "for one device's HBM (docs/design.md §20)")
    p.add_argument("--log_file", type=str, default="auto",
                   help="JSONL event log path; 'auto' derives one under "
                        "--train_dir, 'none' disables")
    p.add_argument("--pad_policy", type=str, default="batch",
                   choices=["batch", "dataset"],
                   help="pad queries to the batch max (least compute) or "
                        "the dataset ceiling (one compile for any batch)")
    p.add_argument("--data_dir", type=str, default="data")
    p.add_argument("--train_dir", type=str, default="output")
    p.add_argument("--batch_size", type=int, default=0,
                   help="0 = reference default for the dataset")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--calibrate", type=int, default=1,
                   help="1: synthesize missing train splits calibrated to "
                        "the real valid/test marginals; 0: generic Zipf "
                        "generator")
    p.add_argument("--cal_rev", choices=["cal2", "cal3"], default="cal2",
                   help="calibrated-stream revision: cal2 or cal3 "
                        "(saturation-compensated item head); tags flow into "
                        "checkpoint names so streams never share "
                        "checkpoints")
    # synthetic scale (used when --dataset synthetic)
    p.add_argument("--synth_users", type=int, default=600)
    p.add_argument("--synth_items", type=int, default=400)
    p.add_argument("--synth_train", type=int, default=50_000)
    p.add_argument("--synth_test", type=int, default=500)
    p.add_argument("--query_batch", type=int, default=0,
                   help="cap queries per device dispatch (0 = all at "
                        "once); >0 routes through the pipelined "
                        "query_many")
    p.add_argument("--synth_stream", choices=["zipf", "cal"],
                   default="zipf",
                   help="synthetic train stream: 'zipf' (the generic generator) "
                        "or 'cal' (cal2-style waterfilled unique pairs "
                        "— scales with no reference heldout, e.g. "
                        "ML-20M fidelity rows)")
    # reliability (fia_tpu_torch/reliability): resumable execution
    p.add_argument("--resume", action="store_true",
                   help="resume an interrupted chain from its progress "
                        "journal: completed test points are loaded, not "
                        "recomputed (journal fingerprint must match — a "
                        "mismatch fails loudly rather than stitching "
                        "rows from a different run)")
    p.add_argument("--deadline", type=float, default=0.0,
                   help="wall-clock budget in seconds (0 = none); the "
                        "chain stops cleanly between test points when "
                        "the budget is spent, with all completed points "
                        "journaled for --resume")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="publish a rotated training checkpoint every N "
                        "steps so a killed run auto-resumes from the "
                        "last good generation (0 = auto: num_steps/4; "
                        "-1 disables periodic checkpointing)")
    p.add_argument("--checkpoint_keep", type=int, default=3,
                   help="rotated checkpoint generations to retain")
    return p


def engine_kwargs(args) -> dict:
    """Solver/impl engine kwargs shared by every driver; the solver name
    routes through the one ladder-aware resolution path
    (``reliability/policy.resolve_solver``); ``--sampled_cap`` and
    ``--sampled_tol`` pass when set.
    """
    from fia_tpu_torch.reliability.policy import resolve_solver

    kw = dict(
        damping=args.damping,
        solver=resolve_solver(args.solver),
        pad_policy=args.pad_policy,
        cg_tol=cg_tol_for(args),
        cg_maxiter=args.cg_maxiter,
        lissa_depth=args.lissa_depth,
        lissa_scale=args.lissa_scale,
        impl=args.impl,
        shard_tables=getattr(args, "model_parallel", 1) > 1,
        device=args.backend,
    )
    if getattr(args, "sampled_cap", None) is not None:
        kw["sampled_cap"] = args.sampled_cap
    if getattr(args, "sampled_tol", None) is not None:
        kw["sampled_tol"] = args.sampled_tol
    return kw


def mesh_for(args):
    """A mesh over the first ``--mesh`` slots of the ``--backend`` device
    (None when 0): 1-D ``data`` by default, 2-D ``('data', 'model')``
    with ``--model_parallel > 1`` (:func:`~fia_tpu_torch.parallel.
    sharded.make_2d_mesh`; ``engine_kwargs`` then asks for row-sharded
    tables)."""
    mp = int(getattr(args, "model_parallel", 1))
    if not getattr(args, "mesh", 0):
        if mp > 1:
            raise SystemExit("--model_parallel > 1 requires --mesh N")
        return None
    from fia_tpu_torch.parallel.mesh import make_mesh
    from fia_tpu_torch.parallel.sharded import make_2d_mesh

    try:
        if mp > 1:
            return make_2d_mesh(args.mesh, model_parallel=mp,
                                device=args.backend)
        return make_mesh(args.mesh, device=args.backend)
    except ValueError as e:  # fewer slots than asked for, or mp ∤ mesh
        raise SystemExit(f"--mesh {args.mesh} requested: {e}")


def event_log_for(args, driver: str):
    """EventLog from --log_file ('auto' derives a per-run path)."""
    from fia_tpu_torch.utils.logging import EventLog

    path = args.log_file
    if path == "none":
        path = None
    elif path == "auto":
        path = os.path.join(
            args.train_dir, f"events-{driver}-{args.model}-{args.dataset}.jsonl"
        )
    return EventLog(path)


def cg_tol_for(args) -> float:
    """Engine cg_tol from the reference's --avextol knob.

    fmin_ncg's avextol bounds the change in the quadratic objective; the
    CG loop stops on the squared-residual ratio, so the scale differs —
    1e-6·avextol reproduces the reference's effective accuracy at its
    default avextol=1e-3. One mapping shared by all drivers.
    """
    return args.avextol * 1e-6


def apply_backend(args) -> torch.device:
    """Resolve ``--backend`` (the torch device; None: the CUDA device)
    once, before any work: without a card and without ``--backend cpu``
    this raises."""
    return resolve_device(args.backend)


def explicit_test_indices(args, test):
    """Validated ``--test_indices`` as an int64 array, or None when the
    flag is unset. The single source of truth for every driver (rq1 via
    pick_test_points, rq2 directly); load_splits also calls it so a
    typo'd index fails BEFORE the training phase, which can cost hours
    on a resumed full protocol."""
    vals = getattr(args, "test_indices", None)
    if not vals:
        return None
    idx = np.asarray(vals, dtype=np.int64)
    if idx.min() < 0 or idx.max() >= test.num_examples:
        raise SystemExit(
            f"--test_indices out of range [0, {test.num_examples})"
        )
    return idx


def load_splits(args):
    if args.dataset == "synthetic":
        if getattr(args, "synth_stream", "zipf") == "cal":
            from fia_tpu_torch.data.synthetic import calibrated_splits

            splits = calibrated_splits(
                args.synth_users, args.synth_items, args.synth_train,
                args.synth_test, seed=args.seed,
            )
            # tag checkpoints so a cal-stream run never loads a
            # Zipf-stream checkpoint (and vice versa)
            args._synth_tag = "calsynth"
        else:
            splits = synthetic_splits(
                args.synth_users, args.synth_items, args.synth_train,
                args.synth_test, seed=args.seed,
            )
    else:
        splits = load_dataset(args.dataset, args.data_dir,
                              synthesize_train=True, synth_seed=args.seed,
                              calibrate=bool(getattr(args, "calibrate", 1)),
                              cal_rev=getattr(args, "cal_rev", "cal2"))
        # generator tag flows into checkpoint/model names (model_name_for):
        # a calibrated-split run must never load a Zipf-split checkpoint
        args._synth_tag = getattr(splits["train"], "synth_tag", "")
    explicit_test_indices(args, splits["test"])  # fail fast, all paths
    return splits


def batch_size_for(args, train) -> int:
    if args.batch_size:
        return args.batch_size
    if args.dataset in BATCH_SIZES:
        return BATCH_SIZES[args.dataset]
    return max(1, min(3000, train.num_examples // 10))


def synth_tag_for(args, splits=None) -> str:
    """The train stream's generator tag ('cal2', 'cal3', 'calsynth',
    '' for real/Zipf streams). Pass ``splits`` whenever they are in
    hand: the tag is read directly from the train split, so it cannot
    silently drop when a caller never went through load_splits (which
    stashes the same tag on args as a fallback for split-free paths).
    The single resolver for checkpoint names AND artifact provenance —
    two sites disagreeing here would let a cal3 run load a cal2
    checkpoint or clobber its artifact."""
    if splits is not None:
        return getattr(splits["train"], "synth_tag", "")
    return getattr(args, "_synth_tag", "")


def model_name_for(args, wd=None, splits=None) -> str:
    """Checkpoint/model-name key (see synth_tag_for on the tag)."""
    wd = args.weight_decay if wd is None else wd
    tag = synth_tag_for(args, splits)
    return (
        f"{args.dataset}_{args.model}_explicit_damping{args.damping:.0e}"
        f"_avextol{args.avextol:.0e}_embed{args.embed_size}"
        f"_maxinf{args.maxinf}_wd{wd:.0e}"
        + (f"_{tag}" if tag else "")
    )


def build_model(args, splits):
    num_users = max(int(np.max(s.x[:, 0])) + 1 for s in splits.values())
    num_items = max(int(np.max(s.x[:, 1])) + 1 for s in splits.values())
    model = MODELS[args.model](
        num_users=num_users, num_items=num_items,
        embedding_size=args.embed_size, weight_decay=args.weight_decay,
    )
    params = model.init_params(torch.Generator().manual_seed(args.seed),
                               device=resolve_device(args.backend))
    return model, params


def train_fingerprint(args, name, num_steps, batch) -> dict:
    """The training-run config fingerprint stamped on checkpoint
    manifests. One resolver for terminal AND rotated generations, so a
    checkpoint from a different config (seed, step budget, lr) is
    rejected at restore time rather than silently trusted."""
    return {
        "kind": "train-ckpt",
        "model_key": name,
        "seed": int(args.seed),
        "num_steps": int(num_steps),
        "batch": int(batch),
        "lr": float(args.lr),
    }


def train_or_load(args, model, params, splits, num_steps=None, verbose=True,
                  event_log=None, mesh=None):
    """Reference RQ2.py:102-109 train-or-load behavior, crash-safe.

    Restore ladder: (1) the terminal checkpoint when valid; (2) the
    newest valid rotated generation from a prior killed run (training
    resumes from its step, not step 0); (3) train from scratch. Training
    publishes rotated generations every --checkpoint_every steps, and a
    corrupt/mismatched terminal checkpoint falls through this ladder
    instead of crashing the driver.
    """
    from fia_tpu_torch.reliability.artifacts import ArtifactIntegrityError
    from fia_tpu_torch.train.trainer import TrainState
    from fia_tpu_torch.utils.io import sweep_stale_tmps

    num_steps = num_steps or args.num_steps_train
    train = splits["train"]
    batch = batch_size_for(args, train)
    cfg = TrainConfig(batch_size=batch, num_steps=num_steps,
                      learning_rate=args.lr, seed=args.seed,
                      log_every=10_000 if verbose else 0)
    trainer = Trainer(model, cfg, event_log=event_log, mesh=mesh,
                      device=args.backend)
    state = trainer.init_state(params)

    name = model_name_for(args, splits=splits)
    ckpt = os.path.join(args.train_dir, f"{name}-checkpoint-{num_steps - 1}")
    fp = train_fingerprint(args, name, num_steps, batch)
    sweep_stale_tmps(args.train_dir)

    if args.load_checkpoint and checkpoint.exists(ckpt):
        print(f"Checkpoint found, loading {ckpt}")
        try:
            p, o, step = checkpoint.load(ckpt, state.params, state.opt_state)
            return trainer, TrainState(
                p, o if o is not None else state.opt_state, step
            ), batch
        except (ArtifactIntegrityError, ValueError) as e:
            # corrupt terminal checkpoint: quarantined by the integrity
            # layer; fall through to rotated generations / retraining
            print(f"Terminal checkpoint rejected ({e}); falling back")

    ckpter = None
    every = int(getattr(args, "checkpoint_every", 0))
    if every == 0:
        every = max(1, num_steps // 4)
    if every > 0:
        ckpter = checkpoint.PeriodicCheckpointer(
            os.path.join(args.train_dir, f"{name}-ckpts"),
            every=every, keep=int(getattr(args, "checkpoint_keep", 3)),
            fingerprint=fp,
        )

    if args.load_checkpoint and ckpter is not None:
        restored = checkpoint.restore_latest_valid(
            ckpter.dir_path, state.params, state.opt_state,
            fingerprint=fp, verbose=verbose,
        )
        if restored is not None:
            p, o, step = restored
            state = TrainState(
                p, o if o is not None else state.opt_state, step
            )
            ckpter._last_step = step

    remaining = num_steps - state.step
    if remaining > 0:
        if verbose:
            what = "Resuming" if state.step else "Training"
            print(f"{what} {args.model} at step {state.step}/{num_steps} "
                  f"(batch {batch})")
        state = trainer.fit(state, train.x, train.y, num_steps=remaining,
                            checkpointer=ckpter)
    os.makedirs(args.train_dir, exist_ok=True)
    checkpoint.save(ckpt, state.params, state.opt_state, state.step,
                    fingerprint=fp)
    if verbose:
        print(f"Saved checkpoint {ckpt}")
    return trainer, state, batch


def pick_test_points(args, splits, engine_index):
    """Random test points, or the least-supported ones when
    sort_test_case=1 (reference RQ1.py:130-137)."""
    test = splits["test"]
    idx = explicit_test_indices(args, test)
    if idx is not None:
        return idx
    rng = np.random.default_rng(args.seed)
    if args.sort_test_case:
        counts = np.array(
            [engine_index.related_count(int(u), int(i)) for u, i in test.x]
        )
        return np.argsort(counts)[: args.num_test]
    return rng.choice(test.num_examples, size=args.num_test, replace=False)
