"""Meshes over the ranks of a ``torch.distributed`` job, and fleet ingest.

Counterpart of ``dmlc_core_tpu/parallel``, with the same exports.  The mesh
helpers (:mod:`.mesh`) import ``torch``; :mod:`.fleet_ingest` is the
host-side lease client.  The names below resolve lazily (PEP 562), as in
the JAX package, so importing this package costs nothing until one is used.
"""

_MESH_EXPORTS = (
    "make_mesh",
    "make_hybrid_mesh",
    "data_sharding",
    "replicated_sharding",
    "local_shard_info",
)

__all__ = list(_MESH_EXPORTS) + ["fleet_ingest"]


def __getattr__(name):
    if name in _MESH_EXPORTS:
        from dmlc_core_tpu_torch.parallel import mesh

        return getattr(mesh, name)
    if name == "fleet_ingest":
        import importlib

        return importlib.import_module("dmlc_core_tpu_torch.parallel.fleet_ingest")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
