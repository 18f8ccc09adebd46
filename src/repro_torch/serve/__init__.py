"""Topic-inference serving for frozen HDP models (counterpart of
``repro/serve``).

Training produces posterior samples of (Phi, Psi); this package turns
one into a deployable artifact and answers topic-inference queries
against it:

  * ``snapshot`` — a training state distilled into an immutable
                   ``ModelSnapshot`` (Phi, Psi and the word-sparse alias
                   tables, built once), with save and load;
  * ``foldin``   — frozen-Phi fold-in Gibbs: the z-step with only the
                   document side live (dense, sparse or the hdp_z CUDA
                   kernel, bitwise equal), and the counter-based
                   uniforms that make a document's chain independent of
                   its batch;
  * ``engine``   — continuous batching over fixed-shape, length-bucketed
                   slots;
  * ``registry`` — a versioned on-disk snapshot registry with atomic
                   publish, between a live training run
                   (``StreamingHDP.run(publish_every_iters=...)``) and a
                   fleet;
  * ``router``   — admission: a bounded shared queue with backpressure,
                   bucket-aware dispatch, ensemble aggregation;
  * ``fleet``    — replicated engines (a thread each, on its own card or
                   CUDA stream) with registry hot swap and posterior
                   ensembles;
  * ``eval``     — held-out document-completion perplexity.

With Phi and Psi frozen the per-word alias tables are exact and never
rebuilt, so query inference is pure sampling against read-only tables.
"""

from repro_torch.serve.snapshot import ModelSnapshot, build_snapshot  # noqa: F401


def __getattr__(name):
    # lazy: the fleet and the registry pull in threading machinery that
    # callers of the plain snapshot and fold-in API never need
    if name == "SnapshotRegistry":
        from repro_torch.serve.registry import SnapshotRegistry
        return SnapshotRegistry
    if name == "ServeFleet":
        from repro_torch.serve.fleet import ServeFleet
        return ServeFleet
    raise AttributeError(name)
