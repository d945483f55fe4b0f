"""heatmap_tpu_torch.serve — the read side of the system: tile serving.

The port's copy of heatmap_tpu/serve for one process: over the same
store it answers every request with the JAX package's status, bytes and
ETag. The reference job existed to feed a serving path (blobs went to
Cassandra for a map frontend, reference heatmap.py:149-150); this
package is that service:

- ``store``  — TileStore: batch egress (``arrays:DIR`` per-level npz,
  including multihost ``host*/`` shards, ``jsonl:``/``dir:`` blob
  records, a ``delta:`` store or ``tilefs:`` mirrors) loaded into a
  read-optimized Morton-keyed per-zoom index with named layers and hot
  ``reload()``;
- ``cache``  — TileCache: thread-safe byte-capped LRU with TTL,
  single-flight render dedup and generation invalidation;
- ``render`` — on-demand tile materialization: exact tiles at stored
  zooms, 2x2 rollup / quadrant upsample at zooms the pyramid lacks,
  PNG (io/png colormap) or reference-compatible JSON counts;
- ``live``   — a HeatmapStream-backed layer whose update ticks
  invalidate only the affected tile keys;
- ``http``   — stdlib ThreadingHTTPServer frontend with ETag/304,
  ``/healthz``, ``/query`` and a Prometheus ``/metrics`` endpoint;
- ``degrade`` and ``dashboard`` — the brownout ladder and the
  operational page;
- ``router`` — stateless fleet frontend: rendezvous hashing with
  bounded-load spill, circuit breakers, hedged reads, admission
  control (typed 503 + Retry-After, never a 500);
- ``fleet``  — supervisor spawning N shared-nothing backend processes
  behind one router, restarting crashers with backoff and re-admitting
  them via half-open health probes.

Everything except ``live`` reads numpy only: serving a finished store
never touches the card, so a tile server stays up beside a busy or dead
one.
"""

from heatmap_tpu_torch.serve.cache import TileCache  # noqa: F401
from heatmap_tpu_torch.serve.store import TileStore  # noqa: F401
from heatmap_tpu_torch.serve.render import (  # noqa: F401
    tile_array, tile_json_bytes, tile_png_bytes,
)
from heatmap_tpu_torch.serve.http import (  # noqa: F401
    ServeApp, make_server, serve_in_thread,
)
from heatmap_tpu_torch.serve.live import LiveLayer  # noqa: F401
from heatmap_tpu_torch.serve.router import (  # noqa: F401
    BackendClient, CircuitBreaker, RouterApp, rendezvous_order, route_key,
)
from heatmap_tpu_torch.serve.fleet import FleetSupervisor  # noqa: F401
