"""The repository's tools on the port, each runnable as
``python -m vizier_tpu_torch.tools.<name>``.

The counterparts of the JAX package's scripts under ``tools/``, with the
same module names, public functions, flags and report keys:

- ``obs_report``: the span report (per-phase latency, one trace's tree,
  program kinds, devices, speculation, SLO burn rates, the soak and the
  merged fleet view);
- ``profile_e2e``: the DEFAULT's ``update`` + ``suggest`` split into stages,
  host time beside CUDA-event time;
- ``warm_start_ab``: warm-started against cold ARD, latency and regret;
- ``surrogate_ab``: the sparse surrogate against the exact GP, latency,
  regret and the off switch's bit identity;
- ``batching_ab``: the batch executor on against off at K studies of one
  bucket, and the mesh arm;
- ``speculative_ab``: the speculative engine on against off on the DEFAULT's
  complete -> suggest loop, through the servicers or the runtime transport;
- ``overload_ab``: the admission plane on against off under the hot-tenant
  flood;
- ``noise_robustness``: the DEFAULT's true regret under each noise model;
- ``budget_policy_ab``: the DEFAULT's regret under its acquisition-budget
  policies.

The tools that measure run on the card (``--device cuda``, the default) or,
at small sizes, on the CPU (``--device cpu``). None writes a file unless
given ``--out``.
"""
