"""Training: the optimizer, the step factory and the fault-tolerant loop.

Counterpart of ``src/repro/train``. ``make_train_step`` / ``init_train_state``
train the transformer LMs (``models/transformer.py``) as the reference's do
on one device; the DLRM's step is the reference's own composition, ``loss ->
backward -> apply_updates``. The trainer checkpoints and resumes through
``repro_torch.checkpoint`` in the reference's on-disk format.
``sharded_train_step`` trains over a device mesh (``parallel``);
``shard_model`` lays a model out on one for serving too."""
from repro_torch.train.optimizer import AdamWConfig, apply_updates, init_state  # noqa: F401
from repro_torch.train.train_step import (  # noqa: F401
    gather_train_state,
    init_train_state,
    make_train_step,
    shard_model,
    shard_train_state,
    sharded_train_step,
    state_shardings,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
