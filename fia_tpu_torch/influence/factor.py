"""The precomputed factorized iHVP tier: the factor bank (port of
``fia_tpu/influence/factor.py``).

The block Hessian of a hot (user, item) pair is factorized offline, so a
query on it answers with one triangular solve or matvec inside the flat
dispatch (the ``precomputed`` rung). The lifecycle is select → factorize
→ publish → load → invalidate:

- :func:`select_hot_pairs` ranks users and items by interaction degree
  and crosses the heads into candidate pairs;
- :func:`build_bank` computes the pairs' damped block Hessians with the
  flat program's ``hessian`` stage (``InfluenceEngine.block_hessians``)
  and factorizes them (:func:`factorize`: a batched Cholesky where the
  block is numerically PD, a sign-keeping clamped-eigendecomposition
  inverse otherwise, optionally polished by Newton–Schulz steps);
- :func:`publish_bank` persists the bank through the artifact integrity
  layer (atomic npz + checksummed manifest, fault site
  ``factor.publish``) under a config fingerprint binding model key,
  block width, damping and the exact train set;
- :func:`load_bank` is a verified read: checksum and fingerprint, then
  each entry's ``dep_crc`` against the CURRENT params and train set, so
  a stale entry is dropped at load and never served;
- :func:`refresh_bank` keeps exactly the entries whose digests still
  match after a params change and republishes them.

The npz layout, the fingerprint and the ``dep_crc`` recipe are the
reference's: a bank either package publishes loads in the other. A
``dep_crc`` digests exactly what the entry's Hessian and scores read:
the parameter rows of every user and item in the pair's related set,
every global parameter (by its ``jax.tree_util.keystr`` path name, which
:func:`_classify_leaves` rebuilds for a dict of tensors or numpy arrays),
the related rows' (x, y) bytes and the solve constants.
"""

from __future__ import annotations

import hashlib
import os
import struct

import numpy as np
import torch

from fia_tpu_torch.reliability import artifacts, sites

# Bump when the npz layout or dep_crc recipe changes: a bank written by
# an older recipe must miss cleanly (fingerprint-mismatch), not serve
# entries validated under different rules.
BANK_VERSION = 1

# Cholesky acceptance: min(diag(L)) must clear this fraction of
# max(diag(L)), else the block is treated as near-singular and the
# clamped-eigendecomposition fallback owns the entry.
_RCOND = 1e-6

KIND_CHOLESKY = 0  # factor holds L with H = L Lᵀ (lower)
KIND_INVERSE = 1   # factor holds an explicit approximate H⁻¹


class FactorBank:
    """An immutable set of factorized block inverses keyed by (u, i).

    Arrays (all host numpy, row ``n`` describes pair ``pairs[n]``):
      pairs   (N, 2) int32 — the (user, item) pairs covered
      kind    (N,)  uint8  — KIND_CHOLESKY or KIND_INVERSE
      factor  (N, d, d) float32 — L or H⁻¹ per ``kind``
      dep_crc (N,)  uint64 — per-entry dependency digest (module doc)
    """

    def __init__(self, pairs, kind, factor, dep_crc):
        self.pairs = np.ascontiguousarray(np.asarray(pairs, np.int32))
        self.kind = np.ascontiguousarray(np.asarray(kind, np.uint8))
        self.factor = np.ascontiguousarray(np.asarray(factor, np.float32))
        self.dep_crc = np.ascontiguousarray(np.asarray(dep_crc, np.uint64))
        n = len(self.pairs)
        if not (len(self.kind) == len(self.factor) == len(self.dep_crc) == n):
            raise ValueError("factor bank arrays disagree on entry count")

    def __len__(self) -> int:
        return len(self.pairs)

    @property
    def block_d(self) -> int:
        return int(self.factor.shape[-1]) if len(self) else 0

    def lookup(self) -> dict:
        """Host hit-test map {(u, i): row}."""
        return {(int(u), int(i)): n for n, (u, i) in enumerate(self.pairs)}

    def take(self, mask: np.ndarray) -> "FactorBank":
        mask = np.asarray(mask, bool)
        return FactorBank(self.pairs[mask], self.kind[mask],
                          self.factor[mask], self.dep_crc[mask])

    @staticmethod
    def empty(block_d: int) -> "FactorBank":
        d = int(block_d)
        return FactorBank(
            np.zeros((0, 2), np.int32), np.zeros((0,), np.uint8),
            np.zeros((0, d, d), np.float32), np.zeros((0,), np.uint64),
        )


def default_bank_path(cache_dir: str, model_name: str) -> str:
    """Canonical on-disk location of a model's bank."""
    return os.path.join(cache_dir, "factor", f"{model_name}-bank.npz")


def bank_fingerprint(model_name: str, block_d: int, damping: float,
                     train_x: np.ndarray, train_y: np.ndarray) -> dict:
    """Manifest fingerprint binding a bank to its config and train set.
    Params freshness is per entry (``dep_crc``), so a params update can
    drop entries surgically instead of voiding the artifact."""
    x = np.ascontiguousarray(np.asarray(train_x, np.int32))
    y = np.ascontiguousarray(np.asarray(train_y, np.float32))
    return {
        "kind": "factor-bank",
        "version": BANK_VERSION,
        "model_key": str(model_name),
        "block_d": int(block_d),
        "damping": repr(float(damping)),
        "train_sha1": hashlib.sha1(x.tobytes() + y.tobytes()).hexdigest(),
    }


# -- hot-pair selection ----------------------------------------------------

def select_hot_pairs(index, max_entries: int = 1024,
                     top_users: int = 64, top_items: int = 64) -> np.ndarray:
    """Candidate (u, i) pairs for the bank, hottest first: the heads of
    users and items by interaction count crossed, each pair scored by the
    product of its degrees; ties break by ascending id. Returns (N, 2)
    int32, N ≤ max_entries."""
    du = np.asarray(index.user_degrees(), np.int64)
    di = np.asarray(index.item_degrees(), np.int64)
    users = np.argsort(-du, kind="stable")[: max(int(top_users), 0)]
    items = np.argsort(-di, kind="stable")[: max(int(top_items), 0)]
    users = users[du[users] > 0]
    items = items[di[items] > 0]
    if users.size == 0 or items.size == 0:
        return np.zeros((0, 2), np.int32)
    uu, ii = np.meshgrid(users, items, indexing="ij")
    pairs = np.stack([uu.ravel(), ii.ravel()], axis=1)
    score = du[pairs[:, 0]] * di[pairs[:, 1]]
    order = np.lexsort((pairs[:, 1], pairs[:, 0], -score))
    pairs = pairs[order][: max(int(max_entries), 0)]
    return np.ascontiguousarray(pairs, np.int32)


# -- per-entry dependency digests ------------------------------------------

def _host_leaf(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _leaves_with_paths(tree, prefix: str = ""):
    """``[(keystr, leaf)]`` of a nested dict, in sorted-key order: the
    path names ``jax.tree_util.keystr`` gives a dict pytree, e.g.
    ``['P']`` or ``['mlp']['W1']``."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(_leaves_with_paths(tree[k], f"{prefix}[{k!r}]"))
        return out
    return [(prefix, tree)]


def _classify_leaves(model, params_host) -> list:
    """Parameter leaves tagged by their keying axis: a leaf whose leading
    dimension equals ``num_users`` is user-keyed, ``num_items``
    item-keyed (both, when it matches both), anything else global.
    Returns ``[(name, arr, tags)]`` sorted by path name."""
    out = []
    for name, leaf in _leaves_with_paths(params_host):
        arr = _host_leaf(leaf)
        tags = set()
        if arr.ndim >= 1 and arr.shape[0] == int(model.num_users):
            tags.add("user")
        if arr.ndim >= 1 and arr.shape[0] == int(model.num_items):
            tags.add("item")
        if not tags:
            tags.add("global")
        out.append((name, arr, tags))
    out.sort(key=lambda t: t[0])
    return out


def dep_crcs(model, params_host, train_x, train_y, index,
             pairs: np.ndarray, damping: float) -> np.ndarray:
    """Per-pair dependency digests under the CURRENT params/train state:
    the parameter rows of every user/item id in the pair's related set
    (and u and i themselves), every global leaf, the related rows' (x, y)
    in gather order, and the solve constants (damping, block width,
    weight decay). An entry whose stored digest equals the fresh one is
    untouched by whatever changed."""
    pairs = np.asarray(pairs, np.int64)
    x = np.ascontiguousarray(np.asarray(train_x, np.int32))
    y = np.ascontiguousarray(np.asarray(train_y, np.float32))
    leaves = _classify_leaves(model, params_host)

    seed = hashlib.blake2b(digest_size=16)
    seed.update(struct.pack("<iid", int(model.block_size), BANK_VERSION,
                            float(damping)))
    seed.update(struct.pack("<d", float(model.weight_decay)))
    for name, arr, tags in leaves:
        if "global" in tags:
            seed.update(name.encode())
            seed.update(np.ascontiguousarray(arr).tobytes())
    seed_digest = seed.digest()

    out = np.empty(len(pairs), np.uint64)
    for n, (u, i) in enumerate(pairs):
        u, i = int(u), int(i)
        urows = np.asarray(index.rows_of_user(u), np.int64)
        irows = np.asarray(index.rows_of_item(i), np.int64)
        rel = np.concatenate([urows, irows])
        users = np.unique(np.concatenate([[u], x[irows, 0]]))
        items = np.unique(np.concatenate([[i], x[urows, 1]]))
        h = hashlib.blake2b(digest_size=8)
        h.update(seed_digest)
        h.update(struct.pack("<qq", u, i))
        for name, arr, tags in leaves:
            if "user" in tags:
                h.update(np.ascontiguousarray(arr[users]).tobytes())
            if "item" in tags:
                h.update(np.ascontiguousarray(arr[items]).tobytes())
        h.update(rel.tobytes())
        h.update(np.ascontiguousarray(x[rel]).tobytes())
        h.update(np.ascontiguousarray(y[rel]).tobytes())
        out[n] = np.uint64(int.from_bytes(h.digest(), "little", signed=False))
    return out


# -- factorization ---------------------------------------------------------

def factorize(H, schulz_polish: bool = False, schulz_iters: int = 8,
              rcond: float = _RCOND, device=None):
    """Factorize a batch of damped block Hessians, (N, d, d) or (d, d).

    A batched Cholesky first (``cholesky_ex``: its info is a tensor, read
    with the rest after the batch, never raised mid-batch). Rows where it
    fails numerically (non-PD, a non-finite L, or a diagonal spread past
    ``rcond``) take a clamped eigendecomposition: eigenvalue magnitudes
    floored at ``rcond·|λ|_max`` with their signs kept (the direct rung
    LU-solves an indefinite system as is) and inverted. With
    ``schulz_polish`` that inverse is refined by best-iterate
    Newton–Schulz steps X ← X(2I − HX). ``device``: where to compute
    (default: H's own device, the CPU for numpy). Returns ``(kind (N,)
    uint8, factor (N, d, d) float32)`` as numpy."""
    H = torch.as_tensor(np.asarray(H) if not torch.is_tensor(H) else H,
                        dtype=torch.float32)
    if device is not None:
        H = H.to(device)
    if H.ndim == 2:
        H = H[None]
    d = H.shape[-1]
    eye = torch.eye(d, dtype=torch.float32, device=H.device)

    L, info = torch.linalg.cholesky_ex(H)
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    ok = ((info == 0)
          & torch.all(torch.isfinite(L).reshape(L.shape[0], -1), dim=-1)
          & (torch.amin(diag, dim=-1)
             > rcond * torch.clamp(torch.amax(diag, dim=-1), min=1e-30)))

    w, V = torch.linalg.eigh(H)
    aw = torch.abs(w)
    floor = torch.clamp(rcond * torch.amax(aw, dim=-1, keepdim=True),
                        min=1e-12)
    wc = torch.where(w < 0, -1.0, 1.0) * torch.maximum(aw, floor)
    Hinv = torch.einsum("nij,nj,nkj->nik", V, 1.0 / wc, V)

    if schulz_polish and int(schulz_iters) > 0:
        def resid(X):
            R = eye[None] - H @ X
            return torch.sqrt(torch.mean(torch.square(R), dim=(-2, -1)))

        best, r_best = Hinv, resid(Hinv)
        X = Hinv
        for _ in range(int(schulz_iters)):
            X = X @ (2.0 * eye[None] - H @ X)
            r = resid(X)
            better = torch.isfinite(r) & (r < r_best)
            best = torch.where(better[:, None, None], X, best)
            r_best = torch.where(better, r, r_best)
        Hinv = best

    factor = torch.where(ok[:, None, None], torch.nan_to_num(L), Hinv)
    kind = torch.where(ok, KIND_CHOLESKY, KIND_INVERSE)
    return (kind.cpu().numpy().astype(np.uint8),
            factor.cpu().numpy().astype(np.float32))


# -- build / publish / load / refresh --------------------------------------

def build_bank(engine, pairs: np.ndarray, batch_queries: int = 512,
               schulz_polish: bool = False) -> FactorBank:
    """Factorize ``pairs``' damped block Hessians into a bank: the
    Hessians from the engine's flat ``hessian`` stage, one dispatch a
    ``batch_queries`` chunk (:meth:`InfluenceEngine.block_hessians`),
    factorized on the engine's device."""
    pairs = np.asarray(pairs, np.int64)
    if pairs.size == 0:
        return FactorBank.empty(engine.model.block_size)
    H = engine.block_hessians(pairs, batch_queries=batch_queries)
    kind, factor = factorize(H, schulz_polish=schulz_polish,
                             device=engine.device)
    crc = dep_crcs(engine.model, engine._params_host,
                   engine._train_host[0], engine._train_host[1],
                   engine.index, pairs, engine.damping)
    return FactorBank(pairs, kind, factor, crc)


def publish_bank(bank: FactorBank, path: str, fingerprint: dict) -> str:
    """Durably publish a bank through the artifact integrity layer (fault
    site ``factor.publish``; damage is caught and quarantined on the next
    verified load)."""
    return artifacts.publish_npz(
        path,
        {"pairs": bank.pairs, "kind": bank.kind, "factor": bank.factor,
         "dep_crc": bank.dep_crc},
        fingerprint=fingerprint,
        site=sites.FACTOR_PUBLISH,
    )


def _bank_from_raw(raw: dict, path: str) -> FactorBank:
    try:
        return FactorBank(raw["pairs"], raw["kind"], raw["factor"],
                          raw["dep_crc"])
    except (KeyError, ValueError) as e:
        # checksum passed but the payload is not a bank: quarantine like
        # any unreadable artifact
        artifacts.quarantine(path, f"bank-malformed: {e}")
        raise artifacts.ArtifactIntegrityError(
            path, "unreadable", f"bank-malformed: {e}")


def load_bank(path: str, engine) -> tuple[FactorBank, int]:
    """Verified bank load against the CURRENT engine state: integrity
    (checksum, config/train fingerprint; a corrupt file is quarantined),
    then each entry's ``dep_crc`` against the live params and train set.
    Returns ``(bank_of_survivors, n_dropped)``; raises
    :class:`~fia_tpu_torch.reliability.artifacts.ArtifactIntegrityError`
    on an integrity failure."""
    fp = bank_fingerprint(engine.model_name, engine.model.block_size,
                          engine.damping, *engine._train_host)
    raw = artifacts.load_npz(path, expected_fingerprint=fp,
                             require_manifest=True)
    bank = _bank_from_raw(raw, path)
    if len(bank) == 0:
        return bank, 0
    fresh = dep_crcs(engine.model, engine._params_host,
                     engine._train_host[0], engine._train_host[1],
                     engine.index, bank.pairs, engine.damping)
    keep = fresh == bank.dep_crc
    return bank.take(keep), int(np.count_nonzero(~keep))


def refresh_bank(model, params_host, train_x, train_y, index, damping,
                 path: str, model_name: str) -> dict:
    """Surgical invalidation after a params/train change: re-digest every
    published entry under the NEW state, republish exactly the survivors
    (their factors are still their Hessians' factors) under the new
    fingerprint. Returns ``{"kept": int, "dropped": int}``; a missing or
    corrupt bank is a no-op (corruption is quarantined as usual)."""
    if not os.path.exists(path):
        return {"kept": 0, "dropped": 0}
    try:
        # integrity only: the old fingerprint is unknowable here
        raw = artifacts.load_npz(path, require_manifest=True)
        bank = _bank_from_raw(raw, path)
    except artifacts.ArtifactIntegrityError:
        return {"kept": 0, "dropped": 0}
    if len(bank):
        fresh = dep_crcs(model, params_host, train_x, train_y, index,
                         bank.pairs, damping)
        keep = fresh == bank.dep_crc
        dropped = int(np.count_nonzero(~keep))
        bank = bank.take(keep)
    else:
        dropped = 0
    fp = bank_fingerprint(model_name, model.block_size, damping,
                          train_x, train_y)
    publish_bank(bank, path, fp)
    return {"kept": len(bank), "dropped": dropped}
