"""Deterministic fault injection and the unified retry policy.

``faults.plane`` owns the process-wide seeded, site-keyed injection
registry; ``faults.retry`` owns bounded-exponential-backoff-with-full-
jitter retries and the per-site policy table. Copies of the JAX
package's ``heatmap_tpu/faults`` (stdlib only).
"""

from heatmap_tpu_torch.faults.plane import (ENV_VAR, SITES, FaultPlane,
                                            InjectedFault, check, get_plane,
                                            hash01, install,
                                            install_from_env, install_spec,
                                            parse_spec)
from heatmap_tpu_torch.faults.retry import (DEFAULT_POLICY,
                                            MAX_REBUILDS_PER_POSITION,
                                            POLICIES, RETRYABLE,
                                            NonRetryable, PoisonedStream,
                                            RetryPolicy, backoff_s,
                                            policy_for, resumable_iter,
                                            retry_call, sleep_backoff)

__all__ = [
    "DEFAULT_POLICY", "ENV_VAR", "FaultPlane", "InjectedFault",
    "MAX_REBUILDS_PER_POSITION", "NonRetryable", "POLICIES",
    "PoisonedStream", "RETRYABLE", "RetryPolicy", "SITES",
    "backoff_s", "check", "get_plane", "hash01", "install",
    "install_from_env", "install_spec", "parse_spec", "policy_for",
    "resumable_iter", "retry_call", "sleep_backoff",
]
