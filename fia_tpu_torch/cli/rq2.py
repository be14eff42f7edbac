"""RQ2 driver: wall-clock cost of influence queries (port of
``fia_tpu/cli/rq2.py``).

Equivalent of reference ``src/scripts/RQ2.py`` + ``RQ2.sh``. Prints the
reference's timer lines plus the same JSON summary line with throughput
numbers. Runs on the CUDA device (``--backend cpu`` for the CPU).

Run:  python -m fia_tpu_torch.cli.rq2 --dataset synthetic --model MF \
        --num_steps_train 2000 --num_test 64 --train_dir /tmp/rq2-smoke
"""

from __future__ import annotations

import json

import numpy as np

from fia_tpu_torch.cli import common


def main(argv=None):
    args = common.base_parser(__doc__).parse_args(argv)
    common.apply_backend(args)

    from fia_tpu_torch.eval.rq2 import time_influence_queries
    from fia_tpu_torch.influence.engine import InfluenceEngine

    splits = common.load_splits(args)
    train, test = splits["train"], splits["test"]
    model, params = common.build_model(args, splits)
    mesh = common.mesh_for(args)
    log = common.event_log_for(args, "rq2")
    log.log("run_start", driver="rq2", **{
        k: v for k, v in vars(args).items() if not k.startswith("_")
    })
    trainer, state, batch = common.train_or_load(
        args, model, params, splits, event_log=log, mesh=mesh
    )

    engine = InfluenceEngine(
        model, state.params, train,
        cache_dir=args.train_dir,
        model_name=common.model_name_for(args, splits=splits),
        mesh=mesh, **common.engine_kwargs(args),
    )

    test_idx = common.explicit_test_indices(args, test)
    if test_idx is None:
        rng = np.random.default_rng(args.seed + 17)
        n_queries = max(args.num_test, 1)
        test_idx = rng.choice(test.num_examples, size=n_queries,
                              replace=False)
    points = test.x[test_idx]

    timing = time_influence_queries(
        engine, points, batch_queries=args.query_batch or None
    )
    # reference-format lines (matrix_factorization.py:225, 249-250)
    print(f"Inverse HVP + scoring for {timing.num_queries} queries took "
          f"{timing.total_time_s} sec")
    print(f"Multiplying by {timing.num_scores} train examples took "
          f"{timing.total_time_s} sec (fused)")
    print(f"Total time is {timing.total_time_s} sec")
    print(json.dumps({"model": args.model, "dataset": args.dataset,
                      "embed_size": args.embed_size, **timing.json()}))
    log.log("query_batch", model=args.model, dataset=args.dataset,
            embed_size=args.embed_size, **timing.json())
    log.close()
    return timing


if __name__ == "__main__":
    main()
