"""Single-device training step and optimizer (JAX ``parallel/train.py``)."""
