"""Shared kernel glue of the port: metrics, fault injection, tracing, cost
attribution and quarantine.

Copies of the jax-free modules of ``janus_tpu/core`` that the executor
imports.  The rest of that package (HPKE, auth tokens, clocks, retries and
the other control-plane modules) comes with the port's control plane; this
``__init__`` therefore re-exports nothing, and callers import the modules.
"""
