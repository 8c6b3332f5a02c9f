from gnnadvisor_osdi21_tpu_torch.models.gat import GAT
from gnnadvisor_osdi21_tpu_torch.models.gcn import GCN
from gnnadvisor_osdi21_tpu_torch.models.gin import GIN

__all__ = ["GAT", "GCN", "GIN"]
