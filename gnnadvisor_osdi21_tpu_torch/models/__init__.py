from gnnadvisor_osdi21_tpu_torch.models.gcn import GCN

__all__ = ["GCN"]
