"""Training and scoring: the objective, the train and score steps, the
AUROC metrics and checkpoints."""
