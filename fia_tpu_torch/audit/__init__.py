"""Influence-driven unlearning & data debugging (port of
``fia_tpu/audit/``).

The influence engine answers "how would removing train row j change
this prediction?"; this package closes the loop and *acts* on the
answer — deletion audits and label-noise triage as a product feature:

- :mod:`fia_tpu_torch.audit.reverse` — the batched **reverse top-k
  sweep**: which training interactions most influence a whole test set,
  streamed through the engine's windowed flat dispatch with a
  deterministic segmented selection on the model's device.
- :mod:`fia_tpu_torch.audit.plan` — turn the most-harmful rows into a
  removal/reweighting :class:`UnlearnPlan` with a predicted test-loss
  delta, and flow it live through the epoch-fenced streaming loop
  (``stream.apply_removal``) under serve traffic.
- :mod:`fia_tpu_torch.audit.verify` — check predicted deltas against
  real leave-one-out retraining on a small slice (sign agreement +
  Spearman fidelity gate), journaled and resumable.

Driver: ``python -m fia_tpu_torch.cli.debug_data``.
"""

from fia_tpu_torch.audit.plan import (  # noqa: F401
    UnlearnPlan,
    apply_plan,
    build_plan,
    load_plan,
    save_plan,
)
from fia_tpu_torch.audit.reverse import SweepResult, reverse_topk  # noqa: F401
from fia_tpu_torch.audit.verify import VerifyResult, verify_plan  # noqa: F401
