"""Multi-device training: destination rows sharded over ``torch.distributed``
ranks, one per card (NCCL) or per process on the host (gloo).  The port of
``gnnadvisor_osdi21_tpu/parallel/``."""
