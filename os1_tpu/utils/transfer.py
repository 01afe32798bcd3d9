"""Device->host transfer discipline.

Premise: a device->host read issued after more work has been enqueued may
be serviced only when the queue ahead of it drains, so a cold
``device_get`` behind queued programs can wait for all of them, while
``copy_to_host_async`` issued at dispatch time enqueues the copy in stream
order and the later read waits only for its own producer. This was observed
on the accelerator transport the system was first built on; whether a
cold read on an NVIDIA GPU pays more than the async copy is not measured.

Rule: NEVER cold-call device_get/np.asarray on a device array after further
dispatches may have been enqueued. Call :func:`fetch` instead — it announces
the copy for every leaf first, then gathers.
"""
from __future__ import annotations

import jax


def announce(tree) -> None:
    """Start async d2h copies for every device-array leaf (no-op on host
    arrays). Call immediately after the producing dispatch."""
    for leaf in jax.tree.leaves(tree):
        try:
            leaf.copy_to_host_async()
        except AttributeError:
            pass


def fetch(tree):
    """announce + gather: the safe blocking device->host read, one gather
    per leaf (a batched-tuple device_get once hung on the earlier
    transport; not measured on the GPU)."""
    announce(tree)
    return jax.tree.map(lambda leaf: jax.device_get(leaf), tree)
