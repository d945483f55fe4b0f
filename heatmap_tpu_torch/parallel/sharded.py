"""Shard bodies over a device mesh: data-parallel binning and cascades.

The port's copy of heatmap_tpu/parallel/sharded.py. Every kernel cuts
its point arrays into one contiguous slice per shard (mesh.split), runs
the JAX shard_map body's work once per shard on that shard's device, and
merges with the explicit collectives of mesh.py:

| JAX (shard_map body)         | here                                  |
|------------------------------|---------------------------------------|
| ``lax.psum`` of rasters      | ``mesh.psum`` (shard-order sum)       |
| ``lax.psum_scatter``         | ``mesh.psum_scatter`` (row blocks)    |
| ``lax.all_gather``           | ``mesh.all_gather``                   |
| ``lax.all_to_all``           | ``mesh.all_to_all``                   |
| ``lax.ppermute``             | ``mesh.ppermute`` (zeros at the edge) |

The per-shard work is the single-device ops: a shard's window raster is
``ops.histogram.bin_points_window`` (the histogram or bucketed CUDA
kernel on the card under ``backend="auto"``), and a shard's detail
reduce on the partitioned backend is the CUDA segment reduce
(``ops.sparse_partitioned``), once per shard. Results that JAX returns
as sharded global arrays come back as global tensors on the mesh's
first device; the stream step keeps its raster's row blocks
(:func:`_rowsharded_blocks`).

On a 2-D (data, tile) mesh the point-parallel kernels shard points over
both axes; :func:`bin_points_bandsharded` uses the tile axis as tile
space (an all-to-all regroups points to the device owning their band).
The cascade pyramids here also exist as global-view programs in
gspmd.py, with byte-identical outputs.
"""

from __future__ import annotations

import torch

from heatmap_tpu_torch.ops import histogram
from heatmap_tpu_torch.ops import pyramid as pyramid_ops
from heatmap_tpu_torch.ops import sparse as sparse_ops
from heatmap_tpu_torch.ops import sparse_partitioned
from heatmap_tpu_torch.parallel import mesh as mesh_mod
from heatmap_tpu_torch.parallel.mesh import DATA_AXIS, TILE_AXIS, Mesh
from heatmap_tpu_torch.tilemath import mercator


def _shard_axes(mesh: Mesh):
    """(axis names, total shards) the point-parallel kernels span:
    ``data`` alone when tile == 1, else both axes flattened."""
    if mesh.shape[TILE_AXIS] == 1:
        return (DATA_AXIS,), mesh.shape[DATA_AXIS]
    return (DATA_AXIS, TILE_AXIS), mesh.shape[DATA_AXIS] * mesh.shape[TILE_AXIS]


def _ones_like_weights(weights, n, dtype, device):
    if weights is None:
        return torch.ones(n, dtype=dtype, device=device)
    return torch.as_tensor(weights, device=device).to(dtype)


def _valid(valid, n, device):
    if valid is None:
        return torch.ones(n, dtype=torch.bool, device=device)
    return torch.as_tensor(valid, device=device).to(torch.bool)


def _over(count, cap, flag):
    """``count``, forced past ``cap`` where ``flag`` (the loud-overflow
    contract of ops/sparse.py)."""
    return torch.where(flag, torch.clamp(count, min=cap + 1), count)


def _local_detail_stage(backend, counts_only, local_capacity, acc_dtype,
                        sentinel, weight_bound=None):
    """The per-shard reduce-by-key: "scatter" (ops/sparse.py sort +
    segment sum) or "partitioned" (sort + the CUDA segment reduce of
    ops/sparse_partitioned.py, the plain version on a CPU tensor). Both
    return the compact (unique[cap], sums[cap], n_unique) contract, so
    the merges downstream are backend-agnostic and bit-identical
    (counts and bounded-integer weighted sums are exact in any order)."""
    if backend == "scatter":
        def stage(k, w, v):
            return sparse_ops.aggregate_keys(
                k, weights=w, valid=v, capacity=local_capacity,
                acc_dtype=acc_dtype)
        return stage
    if backend != "partitioned":
        raise ValueError(f"unknown cascade backend {backend!r}")

    def stage(k, w, v):
        masked = torch.where(v, k, sentinel)
        if counts_only:
            sk = torch.sort(masked).values.to(torch.int64)
            u, s, n = sparse_partitioned.aggregate_sorted_keys_partitioned(
                sk, local_capacity, sentinel=int(sentinel))
        else:
            sk, order = torch.sort(masked, stable=True)
            u, s, n = sparse_partitioned.aggregate_sorted_keys_partitioned(
                sk.to(torch.int64), local_capacity, sentinel=int(sentinel),
                sorted_weights=w[order].to(torch.float64).contiguous(),
                weight_bound=weight_bound)
        # The kernel works on int64 keys and pads with the sentinel as
        # an int64; the stage contract is scatter's, uniques in the
        # INPUT dtype. The merges below derive their pad sentinel from
        # the dtype, so an int64 partial from int32 keys would let the
        # rollup count int32-max pad lanes as real keys. Real keys and
        # the sentinel fit the input dtype, so the cast is lossless.
        return u.to(k.dtype), s.to(acc_dtype), n

    return stage


def _rollup(gu, gs, levels, caps, acc_dtype, sentinel, adaptive=False):
    """The merged pyramid over gathered compact partials:
    ops.pyramid.pyramid_sparse_morton with the keys' own sentinel (the
    partials may be int32 Morton codes, not int64 cascade keys)."""
    u, s, n = sparse_ops.aggregate_keys(
        gu, weights=gs, valid=gu != sentinel, capacity=caps[0],
        acc_dtype=acc_dtype)
    out = [(u, s, n)]
    for lvl in range(1, levels + 1):
        cap = caps[lvl]
        if adaptive:
            keep = pyramid_ops.adaptive_keep(n, u.shape[0])
            if keep is not None:
                u, s = u[:keep], s[:keep]
            cap = min(cap, u.shape[0])
        parents = torch.where(u == sentinel, sentinel, u >> 2)
        u, s, n = sparse_ops.aggregate_sorted_keys(parents, s, cap,
                                                   sentinel=sentinel)
        out.append((u, s, n))
    return out


def _point_shards(mesh, n, weights, valid, dtype, *arrays):
    """Per-shard slices of ``arrays``, the (unit or given) weights and
    the validity mask, each list indexed by shard."""
    devices = mesh.flat
    first = torch.as_tensor(arrays[0])
    w = _ones_like_weights(weights, n, dtype, first.device)
    v = _valid(valid, n, first.device)
    return devices, [mesh_mod.split(a, devices) for a in (*arrays, w, v)]


def _bin_local(mesh, latitude, longitude, window, weights, valid,
               proj_dtype, dtype, backend):
    """Each shard's full (H, W) window raster of its point slice."""
    if dtype is None:
        dtype = torch.int32 if weights is None else torch.float32
    counts_only = weights is None
    n = torch.as_tensor(latitude).shape[0]
    devices, (la, lo, w, v) = _point_shards(mesh, n, weights, valid, dtype,
                                           latitude, longitude)
    rasters = [
        histogram.bin_points_window(
            la[i], lo[i], window, weights=None if counts_only else w[i],
            valid=v[i], proj_dtype=proj_dtype or torch.float64, dtype=dtype,
            backend=backend)
        for i in range(len(devices))
    ]
    return devices, rasters


def bin_points_replicated(latitude, longitude, window: histogram.Window,
                          mesh: Mesh, weights=None, valid=None,
                          proj_dtype=None, dtype=None, backend: str = "auto"):
    """Bin sharded points into a window raster, psum-merged.

    Every shard bins its point slice into a full local (H, W) raster
    (the window kernels on the card under ``backend="auto"``), then the
    rasters sum in shard order. Point arrays must divide by the number
    of point shards (mesh.pad_to_multiple). Count jobs keep the
    count-only kernels: the unit weights are not passed on. Returns the
    merged raster on the mesh's first device.
    """
    devices, rasters = _bin_local(mesh, latitude, longitude, window,
                                  weights, valid, proj_dtype, dtype, backend)
    return mesh_mod.psum(rasters, devices)[0]


def _rowsharded_blocks(latitude, longitude, window, mesh, weights=None,
                       valid=None, proj_dtype=None, dtype=None,
                       backend: str = "auto"):
    """:func:`bin_points_rowsharded`'s row blocks, block ``i`` on shard
    ``i``'s device."""
    _, ndev = _shard_axes(mesh)
    if window.height % ndev:
        raise ValueError(f"window height {window.height} not divisible by {ndev}")
    devices, rasters = _bin_local(mesh, latitude, longitude, window,
                                  weights, valid, proj_dtype, dtype, backend)
    return mesh_mod.psum_scatter(rasters, devices)


def bin_points_rowsharded(latitude, longitude, window: histogram.Window,
                          mesh: Mesh, weights=None, valid=None,
                          proj_dtype=None, dtype=None, backend: str = "auto"):
    """Bin sharded points into a raster left row-sharded across devices.

    The reduce-scatter merges partial rasters and leaves shard ``i``
    owning row block ``i`` of merged tile space. Global shape (H, W);
    ``window.height`` must divide by the number of point shards.
    Returns the row blocks joined on the mesh's first device.
    """
    blocks = _rowsharded_blocks(latitude, longitude, window, mesh,
                                weights, valid, proj_dtype, dtype, backend)
    first = mesh.flat[0]
    return torch.cat([b.to(first) for b in blocks])


def pyramid_rowsharded(raster, levels: int, mesh: Mesh):
    """Pyramid over a row-sharded raster (bin_points_rowsharded's).

    Levels coarsen per row block while every block's height stays even;
    the remaining coarse levels run on the gathered, by then tiny,
    global raster. Returns ``levels + 1`` global rasters.
    """
    _, ndev = _shard_axes(mesh)
    devices = mesh.flat
    raster = torch.as_tensor(raster)
    block_h = raster.shape[0] // ndev
    local_levels = 0
    while local_levels < levels and (block_h >> local_levels) % 2 == 0:
        local_levels += 1
    per_block = [pyramid_ops.pyramid_from_raster(b, local_levels)
                 for b in mesh_mod.split(raster, devices)]
    first = devices[0]
    outs = [torch.cat([p[lvl].to(first) for p in per_block])
            for lvl in range(local_levels + 1)]
    return outs + pyramid_ops.pyramid_from_raster(
        outs[-1], levels - local_levels)[1:]


def _key_shards(mesh, keys, weights, valid, acc_dtype):
    keys = torch.as_tensor(keys)
    n = keys.shape[0]
    w = _ones_like_weights(weights, n, acc_dtype, keys.device)
    v = _valid(valid, n, keys.device)
    devices = mesh.flat
    return devices, [mesh_mod.split(a, devices) for a in (keys, w, v)]


def aggregate_keys_sharded(keys, mesh: Mesh, weights=None, valid=None,
                           capacity=None, acc_dtype=None,
                           local_capacity=None):
    """Global reduce-by-key over sharded keys -> merged uniques/sums.

    Per-shard sort + segment sum (ops/sparse.py), an all-gather of the
    compact per-shard results and a re-reduce on the mesh's first
    device. ``capacity`` bounds the merged unique count;
    ``local_capacity`` the per-shard stage (default ``min(capacity,
    n // ndev)``, clamped to the shard row count). A shard that
    overflows its stage forces the merged count past ``capacity``.
    """
    _, ndev = _shard_axes(mesh)
    keys = torch.as_tensor(keys)
    n = keys.shape[0]
    capacity = n if capacity is None else capacity
    if local_capacity is None:
        local_capacity = min(capacity, n // ndev)
    local_capacity = max(1, min(local_capacity, n // ndev))
    if acc_dtype is None:
        acc_dtype = torch.int32 if weights is None else torch.float32
    sentinel = torch.iinfo(keys.dtype).max
    devices, (ks, ws, vs) = _key_shards(mesh, keys, weights, valid, acc_dtype)
    parts = [sparse_ops.aggregate_keys(ks[i], weights=ws[i], valid=vs[i],
                                       capacity=local_capacity,
                                       acc_dtype=acc_dtype)
             for i in range(ndev)]
    first = devices[0]
    gu = torch.cat([p[0].to(first) for p in parts])
    gs = torch.cat([p[1].to(first) for p in parts])
    gn = torch.stack([p[2].to(first) for p in parts])
    mu, ms, mn = sparse_ops.aggregate_keys(
        gu, weights=gs, valid=gu != sentinel, capacity=capacity,
        acc_dtype=acc_dtype)
    return mu, ms, _over(mn, capacity, (gn > local_capacity).any())


def pyramid_sparse_morton_sharded(codes, mesh: Mesh, weights=None,
                                  valid=None, levels: int = 0, capacity=None,
                                  acc_dtype=None, backend: str = "scatter",
                                  weight_bound: int | None = None):
    """Sharded sparse pyramid: merge the detail level once, then roll up.

    Each shard reduces its slice at detail zoom (``backend`` "scatter"
    or "partitioned", the CUDA segment reduce once per shard on the
    card); one all-gather merges the compact partials; the pyramid then
    rolls up from the merged uniques on the mesh's first device.
    ``capacity`` is an int or a per-level list; the per-shard stage is
    sized ``min(caps[0], shard rows)``. A shard-local overflow forces
    every level's count past its capacity.
    """
    _, ndev = _shard_axes(mesh)
    codes = torch.as_tensor(codes)
    n = codes.shape[0]
    caps = pyramid_ops._level_caps(capacity, n, levels)
    local_capacity = max(1, min(caps[0], n // ndev))
    if acc_dtype is None:
        acc_dtype = torch.int32 if weights is None else torch.float32
    sentinel = torch.iinfo(codes.dtype).max
    stage = _local_detail_stage(backend, weights is None, local_capacity,
                                acc_dtype, sentinel, weight_bound=weight_bound)
    devices, (ks, ws, vs) = _key_shards(mesh, codes, weights, valid,
                                        acc_dtype)
    parts = [stage(ks[i], ws[i], vs[i]) for i in range(ndev)]
    first = devices[0]
    gu = torch.cat([p[0].to(first) for p in parts])
    gs = torch.cat([p[1].to(first) for p in parts])
    over = torch.stack([p[2].to(first) for p in parts]).gt(
        local_capacity).any()
    out = _rollup(gu, gs, levels, caps, acc_dtype, sentinel)
    return [(u, s, _over(c, caps[lvl], over))
            for lvl, (u, s, c) in enumerate(out)]


def _patch_level(pu, ps, spl, lvl, code_bits, cb, sentinel):
    """One coarse level's boundary merge over per-shard rolled-up
    partials ``pu``/``ps`` (lists, one sorted array per shard).

    Boundary codes are the ancestors of the split codes at this level
    (unless a split is tile-aligned). Each shard sends its first ``cb``
    boundary rows; every shard looks its boundary keys up in every
    shard's block, in block order; the lowest-indexed holder keeps the
    cross-shard total and every other holder drops its row. Returns the
    per-shard (new keys, new sums, boundary-overflow flag), each shard
    re-sorted."""
    ndev = len(pu)
    blk = (1 << (2 * lvl)) - 1
    code_mask = (1 << (code_bits - 2 * lvl)) - 1
    is_b, send_u, send_s, bover = [], [], [], []
    for k in range(ndev):
        u, s = pu[k], ps[k]
        sp = spl.to(u.device)
        b = torch.where((sp & blk) != 0, sp >> (2 * lvl), sentinel)
        ib = (u != sentinel) & ((u & code_mask)[:, None] == b[None, :]).any(1)
        bover.append(ib.sum() > cb)
        bkey = torch.where(ib, u, sentinel)
        border = torch.argsort(bkey, stable=True)[:cb]
        is_b.append(ib)
        send_u.append(bkey[border])
        send_s.append(torch.where(ib, s, torch.zeros((), dtype=s.dtype,
                                                      device=s.device))[border])
    out = []
    for k in range(ndev):
        u, s, ib = pu[k], ps[k], is_b[k]
        dev = u.device
        total = torch.zeros_like(s)
        holder = torch.full(u.shape, -1, dtype=torch.int64, device=dev)
        for j in range(ndev):
            bu, bs = send_u[j].to(dev), send_s[j].to(dev)
            pos = torch.clamp(torch.searchsorted(bu, u), 0, cb - 1)
            hit = (bu[pos] == u) & (u != sentinel)
            total = total + torch.where(hit, bs[pos], torch.zeros_like(s))
            holder = torch.where((holder < 0) & hit, j, holder)
        keep = ~ib | (torch.clamp(holder, min=0) == k)
        new_u = torch.where(keep, u, sentinel)
        new_s = torch.where(keep & ib, total, s)
        new_s = torch.where(keep, new_s, torch.zeros_like(s))
        reorder = torch.argsort(new_u, stable=True)
        out.append((new_u[reorder], new_s[reorder], bover[k]))
    return out


def _canonical_levels(per_level, caps, any_over, sentinel):
    """Canonical egress of range-sharded levels: keys are globally
    disjoint after the patch, so a stable argsort of the concatenated
    sentinel-padded shard blocks is the merged order; truncate or pad to
    each level's capacity; the count is the sum of the shards' counts,
    forced past capacity on any overflow."""
    out = []
    for lvl, (us, ss, ns) in enumerate(per_level):
        first = us[0].device
        gu = torch.cat([u.to(first) for u in us])
        gs = torch.cat([s.to(first) for s in ss])
        cap = caps[lvl]
        order = torch.argsort(gu, stable=True)
        su, ss_ = gu[order], gs[order]
        if su.shape[0] >= cap:
            su, ss_ = su[:cap], ss_[:cap]
        else:
            pad = cap - su.shape[0]
            su = torch.cat([su, torch.full((pad,), sentinel, dtype=su.dtype,
                                           device=first)])
            ss_ = torch.cat([ss_, torch.zeros(pad, dtype=ss_.dtype,
                                              device=first)])
        ln = torch.stack([c.to(first) for c in ns]).sum().to(torch.int32)
        out.append((su, ss_, _over(ln, cap, any_over.to(first))))
    return out


def pyramid_sparse_morton_range_sharded(codes, mesh: Mesh, splits, *,
                                        code_bits: int, slot_bound: int,
                                        weights=None, valid=None,
                                        levels: int = 0, capacity=None,
                                        acc_dtype=None,
                                        backend: str = "scatter",
                                        weight_bound: int | None = None):
    """Range-sharded sparse pyramid: local rollup, boundary-only merge.

    Inputs arrive PRE-ROUTED by a Morton partition plan
    (partition.route_emissions): shard ``k``'s contiguous segment holds
    only keys whose detail code lies in range ``k`` of ``splits``, in
    segments of equal length with no tail pad. Each shard rolls its
    range up locally; only boundary tiles (parents whose children
    straddle a split) cross shards: per level every shard's at most
    ``2 * slot_bound`` boundary rows are all-gathered and the first
    holder keeps the cross-shard total (:func:`_patch_level`). The
    canonical egress then sorts the disjoint shard blocks.
    ``code_bits = 2 * detail_zoom``; ``splits`` holds the
    ``n_shards - 1`` split codes.
    """
    _, ndev = _shard_axes(mesh)
    codes = torch.as_tensor(codes)
    n = codes.shape[0]
    if n % ndev != 0:
        raise ValueError(
            f"range-sharded cascade needs n % n_shards == 0, got "
            f"{n} % {ndev} (the host router pads each segment)")
    splits = torch.as_tensor(splits)
    if tuple(splits.shape) != (ndev - 1,):
        raise ValueError(
            f"need {ndev - 1} split codes for {ndev} shards, got "
            f"shape {tuple(splits.shape)}")
    caps = pyramid_ops._level_caps(capacity, n, levels)
    local_capacity = max(1, min(caps[0], n // ndev))
    lcaps = [max(1, min(caps[lvl], local_capacity))
             for lvl in range(levels + 1)]
    bcaps = [max(1, min(lcaps[lvl], 2 * slot_bound))
             for lvl in range(levels + 1)]
    if acc_dtype is None:
        acc_dtype = torch.int32 if weights is None else torch.float32
    sentinel = torch.iinfo(codes.dtype).max
    stage = _local_detail_stage(backend, weights is None, local_capacity,
                                acc_dtype, sentinel, weight_bound=weight_bound)
    devices, (ks, ws, vs) = _key_shards(mesh, codes, weights, valid,
                                        acc_dtype)
    spl = splits.to(codes.dtype)
    parts = [stage(ks[i], ws[i], vs[i]) for i in range(ndev)]
    over = [p[2] > local_capacity for p in parts]
    cur_u = [p[0] for p in parts]
    cur_s = [p[1] for p in parts]
    per_level = [(cur_u, cur_s, [(u != sentinel).sum() for u in cur_u])]
    for lvl in range(1, levels + 1):
        pu, ps = [], []
        for k in range(ndev):
            parents = torch.where(cur_u[k] == sentinel, sentinel,
                                  cur_u[k] >> 2)
            u, s, c = sparse_ops.aggregate_sorted_keys(
                parents, cur_s[k], lcaps[lvl], sentinel=sentinel)
            over[k] = over[k] | (c > lcaps[lvl])
            pu.append(u)
            ps.append(s)
        patched = _patch_level(pu, ps, spl, lvl, code_bits, bcaps[lvl],
                               sentinel)
        cur_u = [p[0] for p in patched]
        cur_s = [p[1] for p in patched]
        over = [o | p[2] for o, p in zip(over, patched)]
        per_level.append((cur_u, cur_s, [(u != sentinel).sum()
                                         for u in cur_u]))
    any_over = torch.stack([o.to(devices[0]) for o in over]).any()
    return _canonical_levels(per_level, caps, any_over, sentinel)


def pyramid_sparse_morton_prefix_sharded(codes, mesh: Mesh, weights=None,
                                         valid=None, levels: int = 0,
                                         capacity=None, acc_dtype=None,
                                         send_capacity: int | None = None,
                                         prefix_levels: int | None = None,
                                         backend: str = "scatter",
                                         weight_bound: int | None = None):
    """Sharded sparse pyramid with a coarse-prefix regrouped merge.

    Stages (the JAX kernel's): per-shard detail reduction (``backend``);
    range splitters by regular sampling (ndev evenly spaced samples per
    shard, a tiled all-gather, every ndev-th of the sorted samples),
    each rounded down to a multiple of ``4^prefix_levels`` so a key and
    its first ``prefix_levels`` ancestors land in one range; one
    all-to-all regroups the compact partials to their range owner
    (``send_capacity`` rows per source and destination); each owner
    merges and rolls its range up through ``prefix_levels`` levels; the
    disjoint ascending range segments are concatenated without a sort;
    levels past ``prefix_levels`` roll up from the concatenation.
    Every overflow (send drop, range buffer, local stage) forces every
    level's count past its capacity. Results equal the replicated
    merge's exactly for counts and integer weighted sums.
    """
    _, ndev = _shard_axes(mesh)
    codes = torch.as_tensor(codes)
    n = codes.shape[0]
    caps = pyramid_ops._level_caps(capacity, n, levels)
    local_capacity = max(1, min(caps[0], n // ndev))
    if prefix_levels is None:
        prefix_levels = 0
        while (prefix_levels < levels
               and ndev * (4 ** (prefix_levels + 1)) <= local_capacity):
            prefix_levels += 1
    prefix_levels = max(0, min(prefix_levels, levels))
    slack = ndev * (4 ** prefix_levels)
    range_caps = [min(caps[lvl], 2 * local_capacity + slack)
                  for lvl in range(prefix_levels + 1)]
    send_cap = (local_capacity if send_capacity is None
                else max(1, min(send_capacity, local_capacity)))
    if acc_dtype is None:
        acc_dtype = torch.int32 if weights is None else torch.float32
    sentinel = torch.iinfo(codes.dtype).max
    prefix_bits = 2 * prefix_levels
    stage = _local_detail_stage(backend, weights is None, local_capacity,
                                acc_dtype, sentinel, weight_bound=weight_bound)
    devices, (ks, ws, vs) = _key_shards(mesh, codes, weights, valid,
                                        acc_dtype)
    parts = [stage(ks[i], ws[i], vs[i]) for i in range(ndev)]
    samples = []
    for u, _, ln in parts:
        pos = (torch.arange(ndev, dtype=torch.int64, device=u.device)
               * torch.clamp(ln.to(torch.int64), max=local_capacity)) // ndev
        samples.append(u[torch.clamp(pos, 0, local_capacity - 1)])
    all_samp = mesh_mod.all_gather(samples, devices, tiled=True)
    send_u, send_s, dropped = [], [], []
    for k, (u, s, _) in enumerate(parts):
        dev = u.device
        picks = (torch.arange(ndev - 1, device=dev) + 1) * ndev
        spl = torch.sort(all_samp[k]).values[picks]
        spl = (spl >> prefix_bits) << prefix_bits
        lane_ok = u != sentinel
        dest = torch.searchsorted(spl, u, right=True)
        dest = torch.where(lane_ok, dest, ndev)
        bounds = torch.searchsorted(
            dest, torch.arange(ndev + 1, dtype=dest.dtype, device=dev))
        starts = bounds[:ndev]
        per_dest = bounds[1:] - bounds[:ndev]
        dropped.append(torch.clamp(per_dest - send_cap, min=0).sum())
        slot = (torch.arange(local_capacity, device=dev)
                - starts[torch.clamp(dest, 0, ndev - 1)])
        ok = (dest < ndev) & (slot < send_cap)
        flat = torch.where(ok, dest * send_cap + slot, ndev * send_cap)
        bu = torch.full((ndev * send_cap + 1,), sentinel, dtype=u.dtype,
                        device=dev)
        bs = torch.zeros(ndev * send_cap + 1, dtype=s.dtype, device=dev)
        # Lanes past a destination's capacity, and pad lanes, land in
        # the spare slot, which is cut off.
        bu.scatter_(0, flat, u)
        bs.scatter_(0, flat, s)
        send_u.append(bu[:-1].reshape(ndev, send_cap))
        send_s.append(bs[:-1].reshape(ndev, send_cap))
    recv_u = mesh_mod.all_to_all(send_u, devices)
    recv_s = mesh_mod.all_to_all(send_s, devices)
    level_parts = []
    for k in range(ndev):
        ru = recv_u[k].reshape(-1)
        mu, ms, mn = sparse_ops.aggregate_keys(
            ru, weights=recv_s[k].reshape(-1), valid=ru != sentinel,
            capacity=range_caps[0], acc_dtype=acc_dtype)
        outs = [(mu, ms, mn)]
        for lvl in range(1, prefix_levels + 1):
            parents = torch.where(mu == sentinel, sentinel, mu >> 2)
            mu, ms, mn = sparse_ops.aggregate_sorted_keys(
                parents, ms, range_caps[lvl], sentinel=sentinel)
            outs.append((mu, ms, mn))
        level_parts.append(outs)
    first = devices[0]
    gln = torch.stack([p[2].to(first) for p in parts])
    gdrop = torch.stack([d.to(first) for d in dropped])
    any_range_over = (gln > local_capacity).any() | (gdrop > 0).any()
    out = []
    for lvl in range(prefix_levels + 1):
        rc, cap = range_caps[lvl], caps[lvl]
        gu = torch.cat([lp[lvl][0].to(first) for lp in level_parts])
        gs = torch.cat([lp[lvl][1].to(first) for lp in level_parts])
        gn = torch.stack([lp[lvl][2].to(first) for lp in level_parts])
        any_range_over = any_range_over | (gn > rc).any()
        cn = torch.clamp(gn, max=rc).to(torch.int64)
        csum = torch.cumsum(cn, 0)
        total = csum[-1]
        j = torch.arange(cap, dtype=torch.int64, device=first)
        dev_of = torch.clamp(torch.searchsorted(csum, j, right=True), 0,
                             ndev - 1)
        local = j - (csum[dev_of] - cn[dev_of])
        idx = torch.clamp(dev_of * rc + local, 0, gu.shape[0] - 1)
        u = torch.where(j < total, gu[idx], sentinel)
        s = torch.where(j < total, gs[idx],
                        torch.zeros((), dtype=gs.dtype, device=first))
        out.append((u, s, _over(total.to(torch.int32), cap, any_range_over)))
    u, s, _ = out[-1]
    for lvl in range(prefix_levels + 1, levels + 1):
        parents = torch.where(u == sentinel, sentinel, u >> 2)
        u, s, n_l = sparse_ops.aggregate_sorted_keys(parents, s, caps[lvl],
                                                     sentinel=sentinel)
        out.append((u, s, _over(n_l, caps[lvl], any_range_over)))
    return out


def splat_rowsharded(raster, kernel_1d, mesh: Mesh):
    """Gaussian splat over a row-sharded raster via halo exchange.

    Each shard owns a horizontal band; the vertical pass needs
    ``len(kernel) // 2`` rows from each neighbour, exchanged with two
    ppermute shifts (zeros arrive at the global edges, matching SAME
    zero padding). The horizontal pass is local. TF32 is off, as in
    ops.splat.splat_raster. Returns the smoothed global raster.
    """
    _, ndev = _shard_axes(mesh)
    devices = mesh.flat
    k = torch.as_tensor(kernel_1d)
    if k.dim() != 1 or k.shape[0] % 2 == 0:
        raise ValueError(
            f"kernel must be 1D with odd length, got shape {tuple(k.shape)}")
    half = (k.shape[0] - 1) // 2
    raster = torch.as_tensor(raster)
    h, _w = raster.shape
    if h % ndev:
        raise ValueError(f"raster height {h} not divisible by {ndev} devices")
    if half and h // ndev < half:
        raise ValueError(
            f"shard height {h // ndev} smaller than kernel half-width "
            f"{half}: halo exchange needs >= one kernel radius per shard")
    out_dtype = raster.dtype if raster.is_floating_point() else k.dtype
    blocks = [b.to(out_dtype) for b in mesh_mod.split(raster, devices)]
    if half:
        down = [(i, i + 1) for i in range(ndev - 1)]
        up = [(i, i - 1) for i in range(1, ndev)]
        top = mesh_mod.ppermute([b[-half:] for b in blocks], devices, down)
        bot = mesh_mod.ppermute([b[:half] for b in blocks], devices, up)
        blocks = [torch.cat([t, b, bb]) for t, b, bb in zip(top, blocks, bot)]
    outs = []
    for b in blocks:
        kd = k.to(device=b.device, dtype=out_dtype)
        x = b[None, None]
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            x = torch.nn.functional.conv2d(x, kd[None, None, :, None])
            x = torch.nn.functional.conv2d(x, kd[None, None, None, :],
                                           padding=(0, half))
        outs.append(x[0, 0])
    first = devices[0]
    return torch.cat([o.to(first) for o in outs])


def bin_points_bandsharded(latitude, longitude, window: histogram.Window,
                           mesh: Mesh, weights=None, valid=None,
                           proj_dtype=None, dtype=None,
                           send_capacity: int | None = None,
                           backend: str = "xla"):
    """Tile-space-parallel binning: no shard materializes the raster.

    Points shard over the whole (data, tile) mesh; each shard projects
    its slice and an all-to-all over the tile axis regroups points to
    the shard owning their horizontal band, which bins only its
    (H/T, W) band; copies across the data axis then sum. Returns
    ``(raster, dropped)``: the (H, W) raster (band ``t`` from tile
    position ``t``) and the global count of points lost to
    ``send_capacity`` (default: the per-shard point count, which cannot
    overflow), summed over both axes. ``backend`` routes the band
    binning ("xla" by default, as in the JAX package).
    """
    T = mesh.shape[TILE_AXIS]
    D = mesh.shape[DATA_AXIS]
    if T < 2:
        raise ValueError(
            "bin_points_bandsharded needs a tile axis >= 2 "
            "(use bin_points_replicated/rowsharded on a data-only mesh)")
    if window.height % T:
        raise ValueError(f"window height {window.height} not divisible by tile={T}")
    band_h = window.height // T
    if dtype is None:
        dtype = torch.int32 if weights is None else torch.float32
    n = torch.as_tensor(latitude).shape[0]
    if n % (D * T):
        raise ValueError(f"{n} points not divisible by {D * T} devices")
    n_local = n // (D * T)
    cap = n_local if send_capacity is None else min(send_capacity, n_local)
    band_window = histogram.Window(zoom=window.zoom, row0=0, col0=0,
                                   height=band_h, width=window.width)
    counts_only = weights is None
    devices, (la, lo, w, v) = _point_shards(mesh, n, weights, valid, dtype,
                                           latitude, longitude)
    send_r, send_c, send_w, dropped = [], [], [], []
    for i, dev in enumerate(devices):
        row, col, pvalid = mercator.project_points(
            la[i], lo[i], window.zoom, dtype=proj_dtype or torch.float64)
        r = row.to(torch.int32) - window.row0
        c = col.to(torch.int32) - window.col0
        ok = (pvalid & v[i] & (r >= 0) & (r < window.height)
              & (c >= 0) & (c < window.width))
        dest = torch.where(ok, torch.div(r, band_h, rounding_mode="floor"),
                           T).to(torch.int64)
        order = torch.argsort(dest, stable=True)
        sd = dest[order]
        bounds = torch.searchsorted(
            sd, torch.arange(T + 1, dtype=sd.dtype, device=dev))
        starts = bounds[:T]
        per_dest = bounds[1:] - bounds[:T]
        dropped.append(torch.clamp(per_dest - cap, min=0).sum())
        slot = (torch.arange(n_local, device=dev)
                - starts[torch.clamp(sd, 0, T - 1)])
        keep = (sd < T) & (slot < cap)
        flat = torch.where(keep, sd * cap + slot, T * cap)

        def fill(x, init, xdtype):
            buf = torch.full((T * cap + 1,), init, dtype=xdtype, device=dev)
            buf.scatter_(0, flat, x[order].to(xdtype))
            return buf[:-1].reshape(T, cap)

        send_r.append(fill(r, -1, torch.int32))
        send_c.append(fill(c, 0, torch.int32))
        send_w.append(fill(w[i], 0, dtype))
    bands = []
    for d in range(D):
        row_devs = devices[d * T:(d + 1) * T]
        sl = slice(d * T, (d + 1) * T)
        recv_r = mesh_mod.all_to_all(send_r[sl], row_devs)
        recv_c = mesh_mod.all_to_all(send_c[sl], row_devs)
        recv_w = mesh_mod.all_to_all(send_w[sl], row_devs)
        row_bands = []
        for t in range(T):
            rr = recv_r[t].reshape(-1)
            row_bands.append(histogram.bin_rowcol_window(
                rr - t * band_h, recv_c[t].reshape(-1), band_window,
                weights=None if counts_only else recv_w[t].reshape(-1),
                valid=rr >= 0, dtype=dtype, backend=backend))
        bands.append(row_bands)
    first = devices[0]
    merged = [mesh_mod.psum([bands[d][t] for d in range(D)],
                            [devices[d * T + t] for d in range(D)])[0]
              for t in range(T)]
    raster = torch.cat([m.to(first) for m in merged])
    total_dropped = torch.stack([x.to(first) for x in dropped]).sum().to(
        torch.int32)
    return raster, total_dropped
