"""The (kf, pt) mesh on torch.distributed: sharded NID refinement, fusion
and pose-graph assembly (Gloo for CPU tensors, NCCL for CUDA tensors)."""

from . import fusion_shard, mesh, nid_shard, pose_graph_shard

__all__ = ["fusion_shard", "mesh", "nid_shard", "pose_graph_shard"]
