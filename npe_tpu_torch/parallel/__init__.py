"""Multi-device training and inference over torch.distributed (npe_tpu
`parallel/`): the ('data', 'model') mesh and its sharding rules
(`mesh.py`), the collectives that carry gradients and the step's data-axis
context (`collectives.py`), and multi-process setup with its demo step
(`multihost.py`)."""
