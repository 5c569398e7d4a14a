"""The socket transport under replication and the lease.

- ``transport``: length-prefixed, CRC-framed messages over TCP or
  Unix-domain sockets through one IO thread per process, with connect and
  request timeouts, seeded reconnect backoff, heartbeats with a
  deadline-based liveness verdict and bounded send buffers. A torn frame
  closes the connection and never corrupts the stream: it resumes by
  cumulative ack on the journal's seqs.
- ``nemesis``: the deterministic network faults of ``ChaosConfig``'s
  ``net_*`` keys (drop, duplicate, delay, reset, partition, bandwidth cap
  and asymmetric "deaf" partitions), functions of (seed, flow, seq).
- ``link``: ``SocketReplicationLink`` and ``SocketStandbyLink``, the
  in-process link's surface over the wire, and ``SocketReplicationHub``,
  ``ReplicationHub``'s surface, so ``MatchmakingApp``,
  ``QueueReplication`` and ``StandbyApplier`` run unchanged.
- ``lease``: ``LeaseService`` and ``RemoteLeaseAuthority``, the lease over
  the same transport, with grants budgeted for the round trip (a renewal
  in flight at the deadline does not count).
- ``failover_proc``: the lease and host child processes of the
  cross-process failover soak, and the soak itself.
"""

from matchmaking_tpu_torch.net.lease import LeaseService, RemoteLeaseAuthority
from matchmaking_tpu_torch.net.link import (
    SocketReplicationHub,
    SocketReplicationLink,
    SocketStandbyLink,
)
from matchmaking_tpu_torch.net.transport import FrameDecoder, FrameError

__all__ = [
    "FrameDecoder", "FrameError", "LeaseService", "RemoteLeaseAuthority",
    "SocketReplicationHub", "SocketReplicationLink", "SocketStandbyLink",
]
