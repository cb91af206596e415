"""The trainers' internals: the per-worker session, run storage, the
worker gang and the executor that drives it."""
