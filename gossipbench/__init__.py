"""The benchmark of `repro_torch`'s multiscale gossip on one NVIDIA H100.

`run` runs one cell (`python3 -m gossipbench.run --workload <cell> ...`);
`registry` finds its files; `reference` and `check` decide `correct`;
`work`, `peaks`, `trace` and ``metrics/`` give the per-layer metrics;
`limits` takes the readings the cells' limits are set from.  It imports
the port from the checkout's ``src/`` and nothing of the JAX package.
"""
