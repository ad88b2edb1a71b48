"""Training substrate of the port: AdamW with its schedule, synthetic
data, ``.npz`` checkpoints and the train step under autograd."""
