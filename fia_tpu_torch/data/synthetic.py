"""Synthetic explicit-rating generators (numpy copy of
``fia_tpu/data/synthetic.py``; the arrays are byte-equal to the
reference's for the same seed).

Ratings are sampled from a planted low-rank MF model plus noise,
quantised to the 1-5 star scale; users and items follow Zipf-ish
popularity marginals, so related-set sizes carry real-data skew. The
calibrated stream (:func:`synthesize_calibrated`, ``:84-465``) fits a
missing train split to the real valid/test files;
:func:`calibrated_splits` (``:502-545``) gives that stream at scales with
no reference files, and :func:`synthesize_scale` (``:599-634``) the
multi-million-user tiers.
"""

from __future__ import annotations

import numpy as np

from fia_tpu_torch.data.dataset import RatingDataset


def synthesize_ratings(
    num_users: int,
    num_items: int,
    num_rows: int,
    seed: int = 0,
    rank: int = 8,
    noise: float = 0.4,
    ensure_cover: np.ndarray | None = None,
) -> RatingDataset:
    """Sample ``num_rows`` (user, item, rating) triples.

    ``ensure_cover`` is an optional (M, 2) array of (u, i) pairs each of
    whose users and items is guaranteed at least one training row.
    """
    rng = np.random.default_rng(seed)

    def _zipf_choice(n, size):
        w = 1.0 / np.arange(1, n + 1) ** 0.8
        w /= w.sum()
        perm = rng.permutation(n)  # decouple popularity from id order
        return perm[rng.choice(n, size=size, p=w)]

    users = _zipf_choice(num_users, num_rows)
    items = _zipf_choice(num_items, num_rows)

    if ensure_cover is not None and len(ensure_cover):
        cover = np.asarray(ensure_cover)
        cu = np.unique(cover[:, 0])
        ci = np.unique(cover[:, 1])
        need = len(cu) + len(ci)
        if need > num_rows:
            raise ValueError("num_rows too small to cover the given pairs")
        users[: len(cu)] = cu
        items[: len(cu)] = rng.integers(0, num_items, size=len(cu))
        users[len(cu) : need] = rng.integers(0, num_users, size=len(ci))
        items[len(cu) : need] = ci

    ratings = _planted_ratings(users, items, num_users, num_items, rng,
                               rank=rank, noise=noise)

    x = np.stack([users, items], axis=1).astype(np.int32)
    return RatingDataset(x, ratings)


def _planted_ratings(users, items, num_users, num_items, rng,
                     rank: int = 8, noise: float = 0.4) -> np.ndarray:
    """Ratings from a planted MF model (r = clip(round(mu + b_u + b_i +
    p_u.q_i + eps), 1, 5))."""
    num_rows = len(users)
    p = rng.normal(0, 1.0 / np.sqrt(rank), size=(num_users, rank))
    q = rng.normal(0, 1.0 / np.sqrt(rank), size=(num_items, rank))
    bu = rng.normal(0, 0.3, size=num_users)
    bi = rng.normal(0, 0.3, size=num_items)
    scores = (
        3.5
        + bu[users]
        + bi[items]
        + np.einsum("nk,nk->n", p[users], q[items])
        + rng.normal(0, noise, size=num_rows)
    )
    return np.clip(np.rint(scores), 1.0, 5.0).astype(np.float32)


def fit_user_degree_profile(
    num_users: int,
    num_rows: int,
    min_degree: int,
    rng,
    sigma: float = 1.0,
    max_degree: int | None = None,
) -> np.ndarray:
    """Per-user train degrees under the reference's leave-4-out protocol.

    The reference valid/test files hold EXACTLY 4 rows per user
    (measured: ml-1m-ex and yelp-ex both have every user at degree 4), so
    user marginals are NOT identifiable from the splits — only two facts
    are pinned down: every user has at least ``min_degree`` train rows
    (the source data's min-ratings filter minus the 4 held out) and the
    mean degree is num_rows/num_users. Within those constraints the
    profile is shifted-lognormal quantiles (σ=1 reproduces the
    magnitude/median/max shape of public MovieLens-1M user degrees),
    scaled exactly to num_rows by largest-remainder rounding and randomly
    permuted over user ids so popularity is decoupled from id order.

    ``max_degree`` caps the profile from above: a real user holds each
    item at most once, so no degree can exceed the item count (the σ=1
    tail overshoots it at ML-1M scale — quantile 6040/6040 lands at
    3833 > 3706 items, which would force duplicate pairs).
    """
    mean = num_rows / num_users
    if mean <= min_degree:
        raise ValueError(
            f"num_rows/num_users = {mean:.1f} <= min_degree {min_degree}"
        )
    if max_degree is not None and mean >= max_degree:
        raise ValueError(
            f"num_rows/num_users = {mean:.1f} >= max_degree {max_degree}"
        )
    from scipy.special import ndtri  # Phi^-1; scipy ships in the image

    mu = np.log(mean - min_degree) - 0.5 * sigma**2
    q = (np.arange(num_users) + 0.5) / num_users
    d = min_degree + np.exp(mu + sigma * ndtri(q))
    # Exact total via two-sided waterfilling: users pinned at the floor
    # (ceiling) take exactly min_degree (max_degree); the free users
    # scale to consume the remaining mass. A single clamp-then-rescale
    # pass can push clamped entries back outside the bounds (the rescale
    # moves everything), so iterate to the fixed point — it terminates
    # because the pinned sets only grow.
    hi = np.inf if max_degree is None else float(max_degree)
    lo_pin = np.zeros(num_users, bool)
    hi_pin = np.zeros(num_users, bool)
    while True:
        free = ~(lo_pin | hi_pin)
        if not free.any():
            raise ValueError("degree profile infeasible")
        # hi is inf when uncapped: inf * 0 = NaN, so the ceiling mass
        # must short-circuit while the hi_pin set is empty
        hi_mass = hi * hi_pin.sum() if hi_pin.any() else 0.0
        mass = num_rows - min_degree * lo_pin.sum() - hi_mass
        scale = mass / d[free].sum()
        new_lo = free & (d * scale < min_degree)
        new_hi = free & (d * scale > hi)
        if not (new_lo.any() or new_hi.any()):
            d = np.where(free, d * scale, np.where(lo_pin, float(min_degree), hi))
            break
        lo_pin |= new_lo
        hi_pin |= new_hi
    base = np.floor(d).astype(np.int64)
    short = num_rows - base.sum()
    order = np.argsort(d - base)[::-1]
    base[order[:short]] += 1
    if base.min() < min_degree or base.sum() != num_rows or (
        max_degree is not None and base.max() > max_degree
    ):
        raise AssertionError("degree profile violated its invariants")
    return base[rng.permutation(num_users)]


def _expected_unique_counts(
    p: np.ndarray, deg_vals: np.ndarray, deg_counts: np.ndarray,
    item_chunk: int = 4096,
) -> np.ndarray:
    """E[# distinct users holding item i] when each user of degree d
    draws d distinct items with marginal probabilities ``p``: the
    standard inclusion approximation 1 - (1-p_i)^d, summed over the
    degree histogram. Exact for with-replacement draws; a slight
    under-count for the generator's without-replacement draws, which
    the caller corrects by rescaling to the known total row count."""
    out = np.empty(len(p))
    l1p = np.log1p(-np.clip(p, 0.0, 1.0 - 1e-12))
    for s in range(0, len(p), item_chunk):
        e = min(s + item_chunk, len(p))
        out[s:e] = (
            deg_counts[None, :]
            * -np.expm1(l1p[s:e, None] * deg_vals[None, :])
        ).sum(axis=1)
    return out


def _dup_mask(users: np.ndarray, items: np.ndarray, num_items: int
              ) -> np.ndarray:
    """All-but-first occurrences of each duplicated (user, item) pair
    — shared by the generator's decollide loop and the head-fit draw
    simulator so their dedup semantics cannot drift apart."""
    codes = users * num_items + items
    order = np.argsort(codes, kind="stable")
    sc = codes[order]
    dup = np.zeros(len(users), bool)
    dup[order[1:]] = sc[1:] == sc[:-1]
    return dup


def _simulate_realized_counts(
    p: np.ndarray, degrees: np.ndarray, rng, rounds: int = 8
) -> np.ndarray:
    """Realized item counts of the generator's draw-then-dedup process
    (iid draws from ``p``, per-user duplicate resampling) — the cheap
    core of :func:`synthesize_calibrated`'s sampling, without the
    heldout-disjointness and coverage passes, which move the marginal
    by well under the head-fit tolerance."""
    num_items = len(p)
    users = np.repeat(np.arange(len(degrees), dtype=np.int64), degrees)
    items = rng.choice(num_items, size=users.size, p=p)
    for _ in range(rounds):
        dup = _dup_mask(users, items, num_items)
        if not dup.any():
            break
        items[dup] = rng.choice(num_items, size=int(dup.sum()), p=p)
    return np.bincount(items, minlength=num_items).astype(np.float64)


def _auto_smoothing(ic: np.ndarray, lo: float = 1e-3, hi: float = 4.0
                    ) -> float:
    """Count-smoothing pseudo-mass calibrated by zero-moment matching.

    Smoothing mass goes ONLY to unseen items (cal2 added +0.5 to every
    item, diluting the head shares it had just fit empirically). If the
    heldout is a fair M-row sample of the true train marginal, the
    number of items it misses pins the unseen-item mass: choose alpha
    so that an M-row multinomial downsample of p proportional to
    (ic + alpha*1{ic==0}) misses E = #(ic == 0) items, i.e. solve
    sum_i (1 - p_i(alpha))^M = E. A fixed 0.1-for-all undershot Yelp's
    low-count tail (scale-matched QQ r 0.9797 vs cal2's 0.9921) and a
    fixed 0.5-for-all re-diluted the head; the masked matched alpha
    tracks each dataset's own sparsity without touching seen shares."""
    M = float(ic.sum())
    z_target = float((ic == 0).sum())
    if z_target == 0:
        return lo

    unseen = ic == 0

    def zeros(alpha: float) -> float:
        p = ic + alpha * unseen
        p = p / p.sum()
        return float(np.exp(M * np.log1p(-np.minimum(p, 1 - 1e-12))).sum())

    if zeros(hi) > z_target:  # even max smoothing leaves more misses
        return hi
    for _ in range(40):
        mid = (lo * hi) ** 0.5
        if zeros(mid) > z_target:
            lo = mid  # too many misses -> unseen items need more mass
        else:
            hi = mid
    return (lo * hi) ** 0.5


def head_compensated_item_weights(
    ic: np.ndarray,
    degrees: np.ndarray,
    num_rows: int,
    smoothing: float | None = None,
    iters: int = 16,
    empirical_iters: int = 2,
) -> np.ndarray:
    """Item sampling weights whose REALIZED (post per-user-uniqueness)
    marginal matches the heldout counts ``ic`` — the cal3 stream fix.

    cal2 sampled items directly from ``ic + 0.5`` and measured a
    lighter head than the heldout ground truth (ML-1M top-1% item mass
    7.2% vs 10.8% — BASELINE §4.2 calibration-evidence row). Two
    mechanisms flatten the head, measured 2026-08-01: the +0.5
    smoothing dilutes ~0.7pp (mass flows to the many zero-count
    items), and per-user pair uniqueness saturates popular items for
    another ~2.9pp — a high-degree user re-drawing a head item keeps
    only one copy, and at train scale the top items' expected counts
    approach the user-count ceiling (ML-1M: 6,500 expected > 6,040
    users), so every overflow draw is redistributed down-tail.

    The fix inverts the saturation in two stages. First a damped
    multiplicative fixed point w <- w * (target / E[realized(w)])^0.7
    over the degree histogram (analytic; converges by ~16 iters —
    measured ML-1M top-1% realized mass 0.1065 vs target 0.1081 at
    iters 16/32/64 alike). The independent-inclusion model slightly
    overestimates head retention under the generator's actual
    draw-then-dedup process (measured draw: 0.0948), so
    ``empirical_iters`` refinement steps then correct against
    :func:`_simulate_realized_counts` with a PRIVATE fixed-seed rng —
    the caller's rng stream is never consumed, keeping cal2 rows
    byte-reproducible. Targets above the hard ceiling (the ML-1M top
    item) converge to partial compensation, the feasible optimum under
    uniqueness. ``smoothing=None`` calibrates the unseen-item
    pseudo-count per dataset by zero-moment matching
    (:func:`_auto_smoothing`); seen items keep their RAW heldout-count
    shares (cal2's +0.5-to-every-item diluted the head it had just
    fit)."""
    if smoothing is None:
        smoothing = _auto_smoothing(ic)
    target = ic.astype(np.float64) + smoothing * (ic == 0)
    target = target / target.sum() * num_rows
    deg_vals, deg_counts = np.unique(degrees, return_counts=True)
    deg_vals = deg_vals.astype(np.float64)
    deg_counts = deg_counts.astype(np.float64)
    w = target.copy()
    for _ in range(iters):
        p = w / w.sum()
        realized = _expected_unique_counts(p, deg_vals, deg_counts)
        realized *= num_rows / realized.sum()
        ratio = target / np.maximum(realized, 1e-9)
        w *= np.clip(ratio, 0.5, 2.0) ** 0.7
    sim_rng = np.random.default_rng(0xCA13)  # private; see docstring
    for _ in range(empirical_iters):
        realized = _simulate_realized_counts(w / w.sum(), degrees, sim_rng)
        ratio = target / np.maximum(realized, 1e-9)
        # a single draw is noisy at the tail (counts of 0/1); trust it
        # only where the target is big enough for relative error ~10%
        ratio = np.where(target >= 100.0, ratio, 1.0)
        w *= np.clip(ratio, 0.5, 2.0) ** 0.7
    return w / w.sum()


def synthesize_calibrated(
    num_users: int,
    num_items: int,
    num_rows: int,
    heldout_x: np.ndarray | None = None,
    seed: int = 0,
    min_degree: int = 16,
    rank: int = 8,
    noise: float = 0.4,
    item_zipf: float = 0.9,
    head_fit: bool = False,
) -> RatingDataset:
    """Train split calibrated to the reference's real valid/test files.

    ``heldout_x`` is the concatenated (valid+test) (M, 2) pair array.
    Item popularity is fit EMPIRICALLY from it (counts + 0.5 smoothing so
    items unseen in the 4-per-user holdout keep mass); user degrees come
    from :func:`fit_user_degree_profile`. Train pairs are kept disjoint
    from the heldout pairs (as the reference's real splits are — they
    were literally held out of train) AND unique among themselves (the
    real splits are sets of distinct (u, i) pairs; a duplicate would
    double-count its row in related sets and Hessians), and every
    heldout item is guaranteed at least one train row so FIA queries
    have non-empty related sets on both sides.

    ``heldout_x=None`` (scales with no reference split, e.g. ML-20M
    stress): item popularity falls back to a permuted
    Zipf(``item_zipf``) profile; everything STRUCTURAL — waterfilled
    user degrees, unique pairs, exact row count — still holds, so the
    stream keeps cal2's realism guarantees minus the empirical item
    marginal (which no surviving data can pin at that scale).

    ``head_fit=True`` is the cal3 stream revision: item weights
    are saturation-compensated against the uniqueness constraint so
    the REALIZED item-degree head matches the heldout counts
    (:func:`head_compensated_item_weights`). Consumes the rng stream
    identically to cal2, so cal2 rows stay reproducible.
    """
    rng = np.random.default_rng(seed)
    if heldout_x is None:
        ic = np.zeros(num_items, np.float64)
        p_item = 1.0 / np.arange(1, num_items + 1) ** item_zipf
        p_item = p_item[rng.permutation(num_items)]
        p_item /= p_item.sum()
        heldout_x = np.empty((0, 2), np.int64)
    else:
        heldout_x = np.asarray(heldout_x)
        ic = np.bincount(
            heldout_x[:, 1], minlength=num_items
        ).astype(np.float64)
        p_item = ic + 0.5
        p_item /= p_item.sum()

    # cap degrees at num_items - 8: a user holds each item at most once,
    # and ~4 items per user live in the heldout split (leave-4-out), so
    # the cap leaves slack for the disjointness constraint
    degrees = fit_user_degree_profile(
        num_users, num_rows, min_degree, rng, max_degree=num_items - 8
    )
    if head_fit and len(heldout_x):
        # cal3: replace the smoothed-count weights with saturation-
        # compensated ones (analytic — consumes no rng, so the draw
        # below sees the same rng state as a cal2 run)
        p_item = head_compensated_item_weights(ic, degrees, num_rows)
    users = np.repeat(np.arange(num_users, dtype=np.int64), degrees)
    items = rng.choice(num_items, size=num_rows, p=p_item)

    # Resample collisions with heldout pairs (the reference train never
    # contains them) and intra-train duplicates (the real splits hold
    # distinct pairs) in one loop; a handful of rounds clears the
    # few-per-mille hits. High-degree users on a skewed item marginal can
    # re-collide with their own rows indefinitely, so stubborn rows fall
    # through to an exact per-user weighted draw WITHOUT replacement
    # (Gumbel top-k over the items the user doesn't already hold).
    held_codes = np.unique(
        heldout_x[:, 0].astype(np.int64) * num_items + heldout_x[:, 1]
    )

    def _bad_mask():
        codes = users * num_items + items
        return np.isin(codes, held_codes) | _dup_mask(users, items,
                                                      num_items)

    for _ in range(16):
        bad = _bad_mask()
        if not bad.any():
            break
        items[bad] = rng.choice(num_items, size=int(bad.sum()), p=p_item)
    bad = _bad_mask()
    if bad.any():
        log_p = np.log(p_item)
        for u in np.unique(users[bad]):
            mine = users == u
            rows = np.flatnonzero(mine & bad)
            g = log_p + rng.gumbel(size=num_items)
            g[items[mine & ~bad]] = -np.inf  # items the user already holds
            lo = np.searchsorted(held_codes, u * num_items)
            hi = np.searchsorted(held_codes, (u + 1) * num_items)
            g[held_codes[lo:hi] - u * num_items] = -np.inf
            if np.isfinite(g).sum() < len(rows):
                raise RuntimeError("user degree exceeds available items")
            items[rows] = np.argpartition(-g, len(rows))[: len(rows)]
    if _bad_mask().any():
        raise RuntimeError("could not decollide train pairs")

    # cover heldout items that drew zero rows: overwrite the item of one
    # random row each (user degrees untouched). A live per-item count
    # guards the donor choice — stealing an item's SOLE row would
    # un-cover it (sparse marginals like yelp's have many 1-row items)
    live = np.bincount(items, minlength=num_items)
    need = np.flatnonzero((ic > 0) & (live == 0))
    if len(need):
        train_codes = np.sort(users * num_items + items)
        new_codes: set[int] = set()

        def _in_train(code: int) -> bool:
            j = np.searchsorted(train_codes, code)
            return (j < len(train_codes) and train_codes[j] == code) or (
                code in new_codes
            )

        cand = rng.permutation(num_rows)
        ci = 0
        for it in need:
            while ci < num_rows:
                r = cand[ci]
                ci += 1
                if live[items[r]] <= 1:
                    continue  # sole remaining row of its item
                code = users[r] * num_items + int(it)
                j = np.searchsorted(held_codes, code)
                # the donor row must not collide with heldout NOR
                # duplicate an existing (u, it) train pair
                if (
                    j == len(held_codes) or held_codes[j] != code
                ) and not _in_train(code):
                    live[items[r]] -= 1
                    items[r] = it
                    live[it] += 1
                    new_codes.add(code)
                    break
            else:
                raise RuntimeError("could not cover heldout items")

    ratings = _planted_ratings(users, items, num_users, num_items,
                               np.random.default_rng(seed + 1),
                               rank=rank, noise=noise)
    perm = rng.permutation(num_rows)
    x = np.stack([users, items], axis=1).astype(np.int32)[perm]
    return RatingDataset(x, ratings[perm])




def sample_heldout_pairs(
    train_x: np.ndarray,
    num_users: int,
    num_items: int,
    n: int,
    seed: int = 17,
) -> np.ndarray:
    """Sample ``n`` distinct (u, i) pairs absent from the training set —
    the benchmark query protocol (test pairs disjoint from train).
    Membership is tested against packed ``u * num_items + i`` codes."""
    rng = np.random.default_rng(seed)
    codes = np.sort(
        np.asarray(train_x[:, 0], np.int64) * num_items
        + np.asarray(train_x[:, 1], np.int64)
    )
    picked: set[int] = set()
    pts: list[tuple[int, int]] = []
    while len(pts) < n:
        u, i = int(rng.integers(0, num_users)), int(rng.integers(0, num_items))
        c = u * num_items + i
        if c in picked:
            continue
        j = np.searchsorted(codes, c)
        if j == len(codes) or codes[j] != c:
            picked.add(c)
            pts.append((u, i))
    return np.asarray(pts, dtype=np.int32)


def synthetic_splits(
    num_users: int,
    num_items: int,
    num_train: int,
    num_test: int,
    seed: int = 0,
    **kw,
) -> dict[str, RatingDataset]:
    """Train/validation/test splits from one planted model, with the
    valid/test pairs disjoint from the training pairs."""
    margin = 4
    while True:
        full = synthesize_ratings(
            num_users, num_items, num_train + margin * num_test, seed=seed, **kw
        )
        train_x, train_y = full.x[:num_train], full.y[:num_train]
        codes = np.sort(
            np.asarray(train_x[:, 0], np.int64) * num_items
            + np.asarray(train_x[:, 1], np.int64)
        )
        rest_x, rest_y = full.x[num_train:], full.y[num_train:]
        rc = np.asarray(rest_x[:, 0], np.int64) * num_items + np.asarray(
            rest_x[:, 1], np.int64
        )
        if codes.size:
            j = np.clip(np.searchsorted(codes, rc), 0, len(codes) - 1)
            heldout = codes[j] != rc
        else:
            heldout = np.ones(len(rc), bool)
        if heldout.sum() >= 2 * num_test:
            rest_x, rest_y = rest_x[heldout], rest_y[heldout]
            break
        margin *= 2  # extremely dense configs: draw more candidates

    train = RatingDataset(train_x, train_y)
    valid = RatingDataset(rest_x[:num_test], rest_y[:num_test])
    test = RatingDataset(
        rest_x[num_test : 2 * num_test], rest_y[num_test : 2 * num_test]
    )
    return {"train": train, "validation": valid, "test": test}


def calibrated_splits(
    num_users: int,
    num_items: int,
    num_train: int,
    num_test: int,
    seed: int = 0,
    min_degree: int = 16,
    rank: int = 8,
    noise: float = 0.4,
) -> dict[str, RatingDataset]:
    """Train/valid/test splits on the cal2-style calibrated stream at
    scales with NO reference heldout files (ML-20M stress).

    Train comes from :func:`synthesize_calibrated` (waterfilled unique
    pairs, Zipf item marginal); valid/test pairs are sampled DISJOINT
    from train (:func:`sample_heldout_pairs`) and rated by the SAME
    planted model as the train split: ``_planted_ratings`` draws the
    planted factors from its rng before any row-dependent consumption,
    so re-seeding ``seed + 1`` reproduces them exactly (only the
    per-row noise differs — as it should).
    """
    min_degree = min(min_degree, max(1, num_train // num_users - 1))
    train = synthesize_calibrated(
        num_users, num_items, num_train, heldout_x=None, seed=seed,
        min_degree=min_degree, rank=rank, noise=noise,
    )
    # checkpoint/cache names key on this tag (cli/common.py
    # model_name_for): a cal-stream run must never resume from or
    # share an influence cache with a Zipf-stream checkpoint
    train.synth_tag = "calsynth"
    pts = sample_heldout_pairs(
        train.x, num_users, num_items, 2 * num_test, seed=seed + 17
    )
    y = _planted_ratings(
        pts[:, 0].astype(np.int64), pts[:, 1].astype(np.int64),
        num_users, num_items, np.random.default_rng(seed + 1),
        rank=rank, noise=noise,
    )
    return {
        "train": train,
        "validation": RatingDataset(pts[:num_test], y[:num_test]),
        "test": RatingDataset(pts[num_test:], y[num_test:]),
    }


#: scale-tier geometry for the table-sharding sweep (docs/design.md
#: §20): name -> (num_users, num_items, num_rows). User-table rows are
#: the scaling axis; train rows grow sublinearly (the hot path's cost
#: is per-query related-set work, not the raw row count).
SCALE_TIERS = {
    "100k": (100_000, 20_000, 400_000),
    "1m": (1_000_000, 100_000, 2_000_000),
    "5m": (5_000_000, 250_000, 4_000_000),
    "10m": (10_000_000, 500_000, 6_000_000),
}


def synthesize_scale(
    num_users: int,
    num_items: int,
    num_rows: int,
    seed: int = 0,
    item_zipf: float = 0.8,
) -> RatingDataset:
    """Streaming-cheap generator for the multi-million-user tiers.

    Unlike :func:`synthesize_ratings` there is no planted factor model —
    an ``(U, rank)`` table at the 10M-user tier would cost more to
    synthesize than the sweep it feeds. Users are uniform (every user
    row is equally likely to be resident-relevant, which is exactly the
    regime row-sharding targets); items follow the Zipf popularity real
    rating streams show, so popular-item queries carry the large
    related sets that stress ``s_pad``; ratings are i.i.d. 1-5 stars
    (score *values* are irrelevant to the perf sweep, and the 100k
    bit-identity stage only needs determinism, which the seed gives).
    """
    rng = np.random.default_rng(seed)
    users = rng.integers(0, num_users, size=num_rows)
    w = 1.0 / np.arange(1, num_items + 1) ** item_zipf
    w /= w.sum()
    perm = rng.permutation(num_items)  # decouple popularity from id order
    items = perm[rng.choice(num_items, size=num_rows, p=w)]
    y = rng.integers(1, 6, size=num_rows).astype(np.float32)
    x = np.stack([users, items], axis=1).astype(np.int32)
    return RatingDataset(x, y)
