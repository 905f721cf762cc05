"""Training: the optimizer. The step factory and the trainer come with the
dense-LM training slice; the DLRM's step is the reference's own composition,
``loss -> backward -> apply_updates``."""
from repro_torch.train.optimizer import AdamWConfig, apply_updates, init_state  # noqa: F401
