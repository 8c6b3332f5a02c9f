from gnnadvisor_osdi21_tpu_torch.models.gcn import GCN
from gnnadvisor_osdi21_tpu_torch.models.gin import GIN

__all__ = ["GCN", "GIN"]
