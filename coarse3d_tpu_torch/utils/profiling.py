"""Reading a ``torch.profiler`` trace: where the host waits for the card.

``host_sync_calls`` lists the CUDA runtime calls of a trace that make the
host wait for the stream (``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize``) or may (``cudaMemcpy``
family), each with the chain of operators it ran under, e.g.
``aten::to > aten::_to_copy > aten::copy_ > cudaMemcpyAsync``: the chain
names the op in the step that caused it.
"""

from __future__ import annotations

import collections

SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize")
COPY_CALLS = ("cudaMemcpyAsync", "cudaMemcpy")


def host_sync_calls(prof, names: tuple[str, ...] = SYNC_CALLS + COPY_CALLS
                    ) -> dict[str, int]:
    """{"op > op > runtime call": count} over a finished profile."""
    out: collections.Counter = collections.Counter()
    for evt in prof.events():
        if evt.name not in names:
            continue
        chain = [evt.name]
        parent = evt.cpu_parent
        while parent is not None:
            chain.append(parent.name)
            parent = parent.cpu_parent
        out[" > ".join(reversed(chain))] += 1
    return dict(out)


def count_calls(calls: dict[str, int], names: tuple[str, ...] = SYNC_CALLS
                ) -> int:
    """How many of ``host_sync_calls``' entries end in one of ``names``."""
    return sum(n for chain, n in calls.items()
               if chain.rsplit(" > ", 1)[-1] in names)
