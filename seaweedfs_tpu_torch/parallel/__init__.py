"""Multi-device plane: the (data, shard) mesh over torch.distributed
(mesh.py), the sharded EC steps and MeshCoder (pipeline.py), and the
launcher of rank processes (launch.py)."""
