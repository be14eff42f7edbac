"""How ``correct`` is decided.

While the window runs, the harness keeps the outputs of a few queries of
every answered job, at positions drawn from the seed, and of each job's
query with the most related rows. Once the
window has closed and the program's state is freed, ``SAMPLE`` of those,
drawn from the seed, and the longest of all are worked out again by the
plain reference (``reference.py``) and compared:

- ``count_mismatch``: queries whose related-row count differs from the
  reference's (the postings gather): limit 0;
- ``nonfinite``: answered queries, over the whole window, with a
  non-finite x = H⁻¹ v: limit 0;
- ``ihvp_err_cond``: the largest ‖x - x_ref‖ / ‖x_ref‖ over the sample
  (the Hessian sums, the batched solve, the shards' assembly);
- ``score_err_cond``: the largest max_j |s_j - s_ref,j| / max_j |s_ref,j|
  over the sample (the row gradients and the score stage, in row order);

each error in units of κ(H) · 2⁻²⁴, the float32 error that the query's
conditioning allows (κ the reference's 2-norm condition number of the
query's Hessian): a sound float32 solve of a query with κ = 10⁵ reads no
worse than one with κ = 10, and a wider precision error shows on every
query alike. A query whose rows lie at a relu kink (NCF) is left out of
these two (``models/ncf.py``). Each cell's limits are in
``checks/<cell>.json``.
"""

from __future__ import annotations

import json
import os

import numpy as np

from fiabench import reference

#: queries a run checks, besides the longest it answered
SAMPLE = 512
#: positions kept of each answered job, drawn from the seed
PER_JOB = 4
#: the numbers compared, in the order they are printed
NAMES = ("count_mismatch", "nonfinite", "ihvp_err_cond", "score_err_cond")
#: float32's unit roundoff
U32 = 2.0 ** -24
HERE = os.path.dirname(os.path.abspath(__file__))


def load_limits(cell: str) -> dict:
    with open(os.path.join(HERE, "checks", f"{cell}.json")) as f:
        limits = json.load(f)
    missing = [n for n in NAMES if n not in limits]
    if missing:
        raise ValueError(f"checks/{cell}.json lacks {missing}")
    return {n: float(limits[n]) for n in NAMES}


class Keeper:
    """The outputs of the queries the check may compare, collected job
    by job as the window answers them."""

    def __init__(self, job_queries: int, seed: int):
        self.job_queries = int(job_queries)
        self.seed = int(seed)
        self.kept: list[dict] = []
        self.longest: dict | None = None
        self.nonfinite = 0
        self.failed_jobs = 0

    def take(self, j: int, job: np.ndarray, results) -> None:
        """Keep job ``j``'s picked queries from its ``query_many``
        results (one per batch, in order) and its longest query."""
        sizes = [len(r.counts) for r in results]
        starts = np.concatenate([[0], np.cumsum(sizes)])
        counts = np.concatenate([r.counts for r in results])
        bad = sum(int((~np.isfinite(r.ihvp).all(axis=1)).sum())
                  for r in results)
        self.nonfinite += bad
        self.failed_jobs += bool(bad)

        def entry(q):
            b = int(np.searchsorted(starts, q, side="right")) - 1
            r, t = results[b], int(q - starts[b])
            return {"pair": job[q].copy(), "count": int(r.counts[t]),
                    "scores": np.array(r.scores_of(t), copy=True),
                    "ihvp": np.array(r.ihvp[t], copy=True)}

        rng = np.random.default_rng([self.seed, 0x636b, int(j)])
        for q in rng.integers(0, self.job_queries, size=PER_JOB):
            self.kept.append(entry(int(q)))
        top = int(np.argmax(counts))
        if self.longest is None or counts[top] > self.longest["count"]:
            self.longest = entry(top)

    def sample(self) -> list[dict]:
        """``SAMPLE`` kept queries drawn from the seed, and the longest."""
        rng = np.random.default_rng([self.seed, 0x736d])
        n = min(SAMPLE, len(self.kept))
        idx = rng.choice(len(self.kept), size=n, replace=False)
        out = [self.kept[k] for k in np.sort(idx)]
        return out + ([self.longest] if self.longest is not None else [])


def compare(cfg: dict, params: dict, ratings, sample: list[dict], device,
            precision: str = "float64") -> dict:
    """The readings of ``sample`` against the reference at float64. At a
    lower ``precision`` the reference, worked out at it, stands in for
    the program's outputs (the control)."""
    pairs = np.stack([s["pair"] for s in sample]).astype(np.int64)
    post = reference.Postings(ratings.x, ratings.num_users, ratings.num_items)
    ref = reference.influence(cfg, params, ratings.x, ratings.y, post, pairs,
                              device)
    answers = sample
    if precision != "float64":
        got = reference.influence(cfg, params, ratings.x, ratings.y, post,
                                  pairs, device, precision)
        answers = [{"count": len(g["rows"]), "scores": g["scores"],
                    "ihvp": g["ihvp"]} for g in got]
    mism, kinks = 0, 0
    out = {"ihvp_err_cond": 0.0, "score_err_cond": 0.0, "ihvp_err": 0.0,
           "score_err": 0.0, "worst_cond": 0.0}
    for a, r in zip(answers, ref):
        if a["count"] != len(r["rows"]) or len(a["scores"]) != len(r["rows"]):
            mism += 1
            continue
        if r["kink"]:
            kinks += 1
            continue
        x, xr = np.asarray(a["ihvp"], np.float64), r["ihvp"]
        s, sr = np.asarray(a["scores"], np.float64), r["scores"]
        e_x = float(np.linalg.norm(x - xr) / max(np.linalg.norm(xr), 1e-300))
        e_s = float(np.max(np.abs(s - sr)) / max(np.max(np.abs(sr)), 1e-300))
        scale = r["cond"] * U32
        if e_x / scale > out["ihvp_err_cond"]:
            out["worst_cond"] = r["cond"]
        for name, e in (("ihvp_err", e_x), ("score_err", e_s)):
            out[name] = max(out[name], e)
            out[name + "_cond"] = max(out[name + "_cond"], e / scale)
    return {"count_mismatch": mism, **out,
            "compared": len(ref) - mism - kinks, "kink_excused": kinks}


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: every compared number at or under its
    limit; ``checks`` maps each name to its value and limit."""
    checks = {n: {"value": readings[n], "limit": limits[n]} for n in NAMES}
    ok = all(np.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return bool(ok) and readings.get("compared", 0) > 0, checks
