"""Tracker pieces of the PyTorch port: the shard-lease control plane.

Counterpart of ``dmlc_core_tpu/tracker/``, cut to
:mod:`.rendezvous`'s lease plane (the rabit rendezvous and the launchers
are not ported).
"""
