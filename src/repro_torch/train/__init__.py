"""Training: the optimizer, the step factory and the fault-tolerant loop.

Counterpart of ``src/repro/train``. ``make_train_step`` / ``init_train_state``
train the dense LM (``models/transformer.py``) as the reference's do on one
device; the DLRM's step is the reference's own composition, ``loss ->
backward -> apply_updates``. The checkpointer, and with it the trainer's
checkpoint hooks, waits for its slice (ROADMAP Queue 1 item 3)."""
from repro_torch.train.optimizer import AdamWConfig, apply_updates, init_state  # noqa: F401
from repro_torch.train.train_step import init_train_state, make_train_step  # noqa: F401
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
