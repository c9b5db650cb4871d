"""Multi-device training over torch.distributed (port of gssr_tpu/parallel)."""
