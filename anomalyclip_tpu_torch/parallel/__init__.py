"""More than one device: data parallelism over ``torch.distributed`` ranks
(mesh.py) and the tensor-parallel CLIP towers (tp.py)."""
