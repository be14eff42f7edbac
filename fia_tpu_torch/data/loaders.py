"""Dataset loaders for the reference's TSV rating files (port of
``fia_tpu/data/loaders.py``).

Parity targets: reference ``src/scripts/load_movielens.py:6-25`` and
``load_yelp.py:6-23`` — tab-separated ``user \t item \t rating`` rows
loaded into train/validation/test datasets, with the reference's exact
row-count slicing preserved when the files have at least that many rows.

Because the reference training blobs are stripped from the repo, missing
train files are (optionally) synthesised at the dataset's published scale
(``synthesize_train=True``), keeping every valid/test user and item
covered so FIA queries have non-empty related sets.
"""

from __future__ import annotations

import os

import numpy as np

from fia_tpu_torch.data.dataset import RatingDataset
from fia_tpu_torch.data.native import parse_tsv
from fia_tpu_torch.data.synthetic import synthesize_calibrated, synthesize_ratings
from fia_tpu_torch.utils import io

# Reference slice counts (load_movielens.py:12-17, load_yelp.py:12-16).
_SPECS = {
    "movielens": dict(
        prefix="ml-1m-ex", n_train=975_460, n_valid=12_074, n_test=12_074,
        num_users=6_040, num_items=3_706,
    ),
    "yelp": dict(
        prefix="yelp-ex", n_train=628_881, n_valid=51_354, n_test=51_153,
        num_users=25_677, num_items=25_815,
    ),
}


def _read_tsv(path: str, n_rows: int | None) -> RatingDataset:
    users, items, ratings = parse_tsv(path, max_rows=n_rows)
    return RatingDataset(np.stack([users, items], axis=1), ratings)


def save_tsv(ds: RatingDataset, path: str) -> None:
    out = np.concatenate([ds.x.astype(np.int64), ds.y.reshape(-1, 1)], axis=1)
    io.savetxt_atomic(path, out, fmt=["%d", "%d", "%g"], delimiter="\t")


def load_dataset(
    name: str,
    data_dir: str,
    synthesize_train: bool = True,
    synth_seed: int = 0,
    calibrate: bool = True,
    cal_rev: str = "cal2",
) -> dict[str, RatingDataset]:
    """Load {train, validation, test} RatingDatasets for a named dataset.

    A missing train file (stripped upstream) is synthesized; by default
    the generator is CALIBRATED to the real valid/test files (empirical
    item marginals, constrained lognormal user degrees, heldout-pair
    disjointness — ``synthesize_calibrated``). ``calibrate=False`` keeps
    the generic Zipf(0.8) generator.
    ``cal_rev`` selects the calibrated-stream revision: ``"cal2"`` or
    ``"cal3"`` (saturation-compensated
    item head — ``head_fit``). The tag flows into checkpoint names so
    the two streams can never share checkpoints or influence caches.
    """
    if name not in _SPECS:
        raise ValueError(f"unknown dataset {name!r}; have {sorted(_SPECS)}")
    spec = _SPECS[name]
    paths = {
        split: os.path.join(data_dir, f"{spec['prefix']}.{short}.rating")
        for split, short in [("train", "train"), ("validation", "valid"), ("test", "test")]
    }

    valid = _read_tsv(paths["validation"], spec["n_valid"])
    test = _read_tsv(paths["test"], spec["n_test"])

    if os.path.exists(paths["train"]):
        train = _read_tsv(paths["train"], spec["n_train"])
    elif synthesize_train:
        cover = np.concatenate([valid.x, test.x], axis=0)
        if calibrate:
            if cal_rev not in ("cal2", "cal3"):
                raise ValueError(f"unknown cal_rev {cal_rev!r}")
            train = synthesize_calibrated(
                spec["num_users"], spec["num_items"], spec["n_train"],
                heldout_x=cover, seed=synth_seed,
                head_fit=(cal_rev == "cal3"),
            )
            # checkpoint/model names key on this tag so calibrated-split
            # checkpoints never collide with the Zipf-split ones
            train.synth_tag = cal_rev
        else:
            train = synthesize_ratings(
                spec["num_users"], spec["num_items"], spec["n_train"],
                seed=synth_seed, ensure_cover=cover,
            )
    else:
        raise FileNotFoundError(
            f"{paths['train']} missing (stripped from the reference repo); "
            "pass synthesize_train=True to regenerate it"
        )
    return {"train": train, "validation": valid, "test": test}


def load_movielens(data_dir: str, **kw) -> dict[str, RatingDataset]:
    return load_dataset("movielens", data_dir, **kw)


def load_yelp(data_dir: str, **kw) -> dict[str, RatingDataset]:
    return load_dataset("yelp", data_dir, **kw)
