"""Distributed job layer of the PyTorch port: launch and rendezvous.

Counterpart of ``dmlc_core_tpu/tracker/``:

- :mod:`.rendezvous` — the Rabit tracker (wire-compatible with Rabit
  clients: magic 0xff99, framed int/str protocol, tree + ring topology,
  jobid-based rank recovery), the PS bootstrap, and the fleet-ingest
  shard-lease coordinator;
- :mod:`.submit` / :mod:`.opts` — the launcher CLI (``python -m
  dmlc_core_tpu_torch.tracker.submit``) and its option schema;
- backends: :mod:`.local` (one process per worker on this host, with
  retry), :mod:`.ssh`, :mod:`.mpi`, :mod:`.sge`, :mod:`.tpu_vm`,
  :mod:`.yarn` (with the container supervisor of
  :mod:`.yarn_supervisor`) and :mod:`.mesos`;
- :mod:`.filecache` / :mod:`.launcher` — job file shipping and the
  container-side bootstrap.
"""

from dmlc_core_tpu_torch.tracker.rendezvous import PSTracker, RabitTracker  # noqa: F401


def __getattr__(name):
    # imported on first use, so that ``python -m
    # dmlc_core_tpu_torch.tracker.submit`` runs a module not yet imported
    if name == "submit_job":
        from dmlc_core_tpu_torch.tracker.submit import submit_job

        return submit_job
    raise AttributeError(name)
