"""Fault tolerance of the training loop (port of the single-process parts
of ``hyperscalees_t2i_tpu/resilience/``): bounded I/O retries, versioned
checksummed checkpoint slots, the non-finite rollback policy and
SIGTERM/SIGINT preemption."""
