"""Checkpointing (port of ``fia_tpu/train/checkpoint.py:42-250``).

A checkpoint is the (params, opt_state, step) triple saved as an npz of
flattened leaves, in the reference's layout, so each package reads the
other's files (``checkpoint.py:47-62``):

- ``p{i}``: the params leaves in sorted-key order, and ``__ptree__``, the
  string of their ``jax.tree_util`` structure, e.g.
  ``PyTreeDef({'P': *, 'Q': *, 'bg': *, 'bi': *, 'bu': *})``;
- ``o{i}``: the optimizer leaves — Adam's int32 ``count``, then the
  ``mu`` dict, then the ``nu`` dict, each in sorted-key order — and
  ``__otree__``, the string of ``optax.adam``'s state structure,
  ``PyTreeDef((CustomNode(namedtuple[ScaleByAdamState], [*, {...},
  {...}]), CustomNode(namedtuple[EmptyState], [])))``;
- ``__step__``.

The port writes and checks those strings without JAX (:func:`treedef`).
Loading restores into a template with matching structure, leaf shapes
AND dtypes: two configs with the same structure but other embedding
widths never restore into each other.

Persistence goes through the artifact integrity layer
(:mod:`fia_tpu_torch.reliability.artifacts`): every save is an atomic
publish with a checksummed, fingerprinted manifest, and every load
verifies before deserialising. On top sit :func:`save_rotated` (a
last-K ``ckpt-<step>.npz`` directory), :func:`restore_latest_valid`
(newest generation that passes validation; corrupt ones quarantined)
and :class:`PeriodicCheckpointer` (the trainer's hook). Sharded
params (the ``Placed`` row shards of a ``('data', 'model')`` mesh,
restored with their placement) checkpoint through
:mod:`fia_tpu_torch.train.checkpoint_orbax`, the counterpart of the
reference's orbax variant on ``torch.distributed.checkpoint``.
"""

from __future__ import annotations

import os
import re

import numpy as np
import torch

from fia_tpu_torch import obs
from fia_tpu_torch.reliability import artifacts, sites
from fia_tpu_torch.train.trainer import AdamState

_GEN_RE = re.compile(r"^ckpt-(\d+)\.npz$")


def _dict_def(d: dict) -> str:
    return "{" + ", ".join(f"'{k}': *" for k in sorted(d)) + "}"


def treedef(tree) -> str:
    """The reference's ``str(jax.tree_util.tree_structure(...))`` of a
    params dict or an Adam state (``optax.adam``'s
    ``(ScaleByAdamState, EmptyState)`` chain)."""
    if isinstance(tree, AdamState):
        return ("PyTreeDef((CustomNode(namedtuple[ScaleByAdamState], [*, "
                f"{_dict_def(tree.mu)}, {_dict_def(tree.nu)}]), "
                "CustomNode(namedtuple[EmptyState], [])))")
    if isinstance(tree, dict):
        return f"PyTreeDef({_dict_def(tree)})"
    raise TypeError(f"no checkpoint layout for {type(tree).__name__}")


def _host(leaf) -> np.ndarray:
    return leaf.detach().cpu().numpy() if torch.is_tensor(leaf) else np.asarray(leaf)


def leaves(tree) -> list:
    """The leaves in the reference's flattening order."""
    if isinstance(tree, AdamState):
        return [tree.count, *leaves(tree.mu), *leaves(tree.nu)]
    return [tree[k] for k in sorted(tree)]


def _unflatten(template, got: list, device):
    """``template``'s structure filled with the arrays ``got``."""
    put = [torch.as_tensor(np.array(g)).to(device) for g in got]
    if isinstance(template, AdamState):
        keys = sorted(template.mu)
        n = len(keys)
        return AdamState(put[0], dict(zip(keys, put[1 : 1 + n])),
                         dict(zip(sorted(template.nu), put[1 + n :])))
    return dict(zip(sorted(template), put))


def _device_of(tree):
    leaf = leaves(tree)[0]
    return leaf.device if torch.is_tensor(leaf) else torch.device("cpu")


def save(path: str, params, opt_state=None, step: int = 0,
         fingerprint=None) -> str:
    """Durably publish a checkpoint (npz + manifest); returns the path."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"p{i}": _host(l) for i, l in enumerate(leaves(params))}
    payload["__ptree__"] = np.array(treedef(params))
    if opt_state is not None:
        payload.update({f"o{i}": _host(l)
                        for i, l in enumerate(leaves(opt_state))})
        payload["__otree__"] = np.array(treedef(opt_state))
    payload["__step__"] = np.array(step)
    out = path if path.endswith(".npz") else path + ".npz"
    artifacts.publish_npz(out, payload, fingerprint=fingerprint,
                          site=sites.CHECKPOINT_PUBLISH)
    return out


def _validate_leaves(got, template, path: str, what: str) -> None:
    """Leaf-level shape/dtype validation against the template: the
    structure string is blind to leaf shapes."""
    t_leaves = leaves(template)
    if len(got) != len(t_leaves):
        raise ValueError(
            f"checkpoint {what} leaf count {len(got)} != template "
            f"{len(t_leaves)} in {path}"
        )
    for i, (g, t) in enumerate(zip(got, t_leaves)):
        ts = tuple(t.shape)
        gs = tuple(np.shape(g))
        if ts != gs:
            raise ValueError(
                f"checkpoint {what} leaf {i} shape {gs} != template "
                f"{ts} in {path}"
            )
        td = (np.dtype(str(t.dtype).removeprefix("torch."))
              if torch.is_tensor(t) else np.asarray(t).dtype)
        if np.dtype(g.dtype) != td:
            raise ValueError(
                f"checkpoint {what} leaf {i} dtype {g.dtype} != template "
                f"{td} in {path}"
            )


def load(path: str, params_template, opt_template=None, *,
         fingerprint=None, require_manifest: bool = False):
    """Load a checkpoint into (params, opt_state, step), on the
    templates' device.

    The file is verified against its integrity manifest first (lenient
    on manifest-less legacy files unless ``require_manifest``); corrupt
    files are quarantined and raise
    :class:`~fia_tpu_torch.reliability.artifacts.ArtifactIntegrityError`.
    Structures, leaf shapes and dtypes are then validated against the
    templates (ValueError on mismatch).
    """
    if not path.endswith(".npz"):
        path = path + ".npz"
    z = artifacts.load_npz(path, expected_fingerprint=fingerprint,
                           require_manifest=require_manifest)
    pleaves = [z[f"p{i}"] for i in range(_count(z, "p"))]
    if treedef(params_template) != str(z["__ptree__"]):
        raise ValueError(f"checkpoint param structure mismatch in {path}")
    _validate_leaves(pleaves, params_template, path, "param")
    params = _unflatten(params_template, pleaves, _device_of(params_template))
    opt_state = None
    if opt_template is not None and "__otree__" in z:
        oleaves = [z[f"o{i}"] for i in range(_count(z, "o"))]
        if treedef(opt_template) != str(z["__otree__"]):
            raise ValueError(f"checkpoint opt structure mismatch in {path}")
        _validate_leaves(oleaves, opt_template, path, "opt")
        opt_state = _unflatten(opt_template, oleaves, _device_of(opt_template))
    step = int(z["__step__"])
    return params, opt_state, step


def _count(z, prefix: str) -> int:
    n = 0
    while f"{prefix}{n}" in z:
        n += 1
    return n


def exists(path: str) -> bool:
    return os.path.isfile(path if path.endswith(".npz") else path + ".npz")


# -- rotated last-K generations + last-good-fallback restore ---------------

def generations(dir_path: str) -> list[tuple[int, str]]:
    """(step, path) of every checkpoint generation, oldest first.
    Quarantined (``*.corrupt``) files never match the name pattern."""
    if not os.path.isdir(dir_path):
        return []
    gens = []
    for name in os.listdir(dir_path):
        m = _GEN_RE.match(name)
        if m:
            gens.append((int(m.group(1)), os.path.join(dir_path, name)))
    return sorted(gens)


def save_rotated(dir_path: str, params, opt_state=None, step: int = 0, *,
                 keep: int = 3, fingerprint=None) -> str:
    """Publish ``ckpt-<step>.npz`` into a rotated last-K directory; older
    generations beyond ``keep`` are pruned (quarantined files are never
    touched), and stale temp files of a killed writer swept first."""
    from fia_tpu_torch.utils.io import sweep_stale_tmps

    os.makedirs(dir_path, exist_ok=True)
    sweep_stale_tmps(dir_path)
    out = save(os.path.join(dir_path, f"ckpt-{int(step):08d}.npz"),
               params, opt_state, step, fingerprint=fingerprint)
    gens = generations(dir_path)
    for _, stale_path in gens[:-keep] if keep > 0 else []:
        if os.path.abspath(stale_path) == os.path.abspath(out):
            continue
        for p in (stale_path, artifacts.manifest_path(stale_path)):
            try:
                os.unlink(p)
            except OSError:
                pass
    return out


def restore_latest_valid(dir_path: str, params_template, opt_template=None,
                         *, fingerprint=None, verbose: bool = True):
    """Restore the newest generation that passes full validation.

    Newest first: a generation failing checksum/size/manifest checks is
    quarantined (by the integrity layer) and the walk goes on; one with
    another fingerprint or structure (another config's checkpoint in a
    shared directory) is skipped and left in place. Returns (params,
    opt_state, step) or None when no generation is valid.
    """
    for step, path in reversed(generations(dir_path)):
        try:
            out = load(path, params_template, opt_template,
                       fingerprint=fingerprint, require_manifest=True)
        except artifacts.ArtifactIntegrityError as e:
            if verbose:
                obs.diag(
                    "artifacts",
                    f"checkpoint {os.path.basename(path)} rejected "
                    f"({e.reason}); falling back to an older generation",
                )
            continue
        except ValueError as e:
            if verbose:
                obs.diag(
                    "artifacts",
                    f"checkpoint {os.path.basename(path)} skipped "
                    f"(template mismatch: {e})",
                )
            continue
        if verbose:
            obs.diag(
                "artifacts",
                f"restored step {step} from {os.path.basename(path)}",
            )
        return out
    return None


class PeriodicCheckpointer:
    """Publishes rotated checkpoint generations every ``every`` steps
    (``every <= 0`` disables it); the trainer calls :meth:`maybe` at
    dispatch boundaries."""

    def __init__(self, dir_path: str, every: int, keep: int = 3,
                 fingerprint=None):
        self.dir_path = dir_path
        self.every = int(every)
        self.keep = int(keep)
        self.fingerprint = fingerprint
        self._last_step = 0

    def maybe(self, params, opt_state, step: int) -> str | None:
        if self.every <= 0 or step - self._last_step < self.every:
            return None
        return self.save(params, opt_state, step)

    def save(self, params, opt_state, step: int) -> str:
        self._last_step = int(step)
        return save_rotated(self.dir_path, params, opt_state, step,
                            keep=self.keep, fingerprint=self.fingerprint)
