"""Training/eval harness for the anomaly scorers."""

from alaz_tpu_torch.train.objective import edge_bce_loss
from alaz_tpu_torch.train.trainstep import TrainState, make_train_step, train_on_batches
from alaz_tpu_torch.train.metrics import auroc

__all__ = ["edge_bce_loss", "TrainState", "make_train_step", "train_on_batches", "auroc"]
