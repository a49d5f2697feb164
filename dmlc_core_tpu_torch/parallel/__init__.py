"""Meshes over the ranks of a ``torch.distributed`` job."""
