"""Divergence scheduling between sweeps (the port's copy of
``raytpu/ops/rebin.py``): lanes permuted before a consensus sweep and put
back after it, ``RenderConfig.divergence``.

* ``"sort"``: a stable segmented sort of the lanes by a key, the direction
  octant of a live lane and 8 for a dead one (:func:`octant_key`), within
  segments of ``SEG_PACKETS`` packets (or 32, 16, 8 where the wave is not
  whole segments of 64), so that dead lanes sink to their segment's tail and
  live lanes bin by octant (:func:`rebin_perm`); the result planes go back
  through the inverse permutation.
* ``"split"`` / ``"split_all"``: at spp 2 or 4 in the folded layout (a
  tile's sample packets adjacent), each tile's packets are regrouped so
  that one packet holds every sample of a half or quarter of the tile
  (:func:`tile_split`), a fixed reshape and transpose; :func:`tile_merge`
  undoes it.

The integrator applies them where the JAX package does
(``raytpu/ops/trace.py:188-225``, :376-410): around the consensus sweeps
only (``_tier`` "mega"). The port's consensus group is the warp
(``ops/consensus.py``), so a permutation changes only which lanes share a
warp and a culling block: the hits are the same but where two triangles
are hit at exactly the same t.
"""

from __future__ import annotations

import torch

from raytpu_torch.ops.mega import BLOCK_PACKETS

SEG_PACKETS = 64  # packets of a sort segment (raytpu/ops/mega.py)
DIVERGENCE = ("off", "split", "split_all", "sort")


def _seg_packets(p: int) -> int:
    """The largest segment length that divides the packet count (0 if
    none does)."""
    for seg in (SEG_PACKETS, 32, 16, BLOCK_PACKETS):
        if p % seg == 0:
            return seg
    return 0


def octant_key(d, live: torch.Tensor) -> torch.Tensor:
    """Per-lane sort key (P, K) int32: the direction octant of a live lane,
    8 for a dead one."""
    key = ((d[0] < 0).to(torch.int32) | ((d[1] < 0).to(torch.int32) << 1)
           | ((d[2] < 0).to(torch.int32) << 2))
    return torch.where(live, key, 8)


def rebin_perm(key: torch.Tensor):
    """Stable segmented argsort of ``key`` (P, K) -> ``(sigma, rank,
    seg)``: ``sigma`` gathers planes into binned order, ``rank`` gathers
    them back (the inverse permutation), both (S, seg*K) int64 over
    segments of ``seg`` packets; ``seg == 0`` means no segment length
    divides P (the caller does not re-bin)."""
    p, k = key.shape
    seg = _seg_packets(p)
    if seg == 0:
        return None, None, 0
    sigma = torch.argsort(key.reshape(-1, seg * k), dim=1, stable=True)
    rank = torch.argsort(sigma, dim=1, stable=True)
    return sigma, rank, seg


def permute(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Apply a segmented lane permutation to one (P, K) plane."""
    return x.reshape(perm.shape).gather(1, perm).reshape(x.shape)


def permute_vec3(v, perm):
    return tuple(permute(c, perm) for c in v)


def permute_planes(x: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Apply the permutation to a stacked (N, P, ...) plane tensor (the
    packed (9, P, K) trace state)."""
    n = x.shape[0]
    flat = x.reshape(n, *perm.shape)
    return flat.gather(2, perm.expand(n, *perm.shape)).reshape(x.shape)


def can_split(p: int, k: int, spp: int) -> bool:
    return k == 1024 and spp in (2, 4) and p % spp == 0


def tile_split(x: torch.Tensor, spp: int) -> torch.Tensor:
    """(P, K) spp-interleaved tile packets -> sub-tile x spp packets."""
    p, k = x.shape
    t = p // spp
    if spp == 4:
        # lanes iy*32+ix = (qy*16+ry)*32 + qx*16+rx -> dims (qy, ry, qx, rx)
        y = x.reshape(t, 4, 2, 16, 2, 16)         # (t, s, qy, ry, qx, rx)
        return y.permute(0, 2, 4, 1, 3, 5).reshape(p, k)
    if spp == 2:
        y = x.reshape(t, 2, 2, 16, 32)            # (t, s, qy, ry, ix)
        return y.permute(0, 2, 1, 3, 4).reshape(p, k)
    return x


def tile_merge(x: torch.Tensor, spp: int) -> torch.Tensor:
    """Inverse of :func:`tile_split`."""
    p, k = x.shape
    t = p // spp
    if spp == 4:
        y = x.reshape(t, 2, 2, 4, 16, 16)         # (t, qy, qx, s, ry, rx)
        return y.permute(0, 3, 1, 4, 2, 5).reshape(p, k)
    if spp == 2:
        y = x.reshape(t, 2, 2, 16, 32)            # (t, qy, s, ry, ix)
        return y.permute(0, 2, 1, 3, 4).reshape(p, k)
    return x


def tile_split_vec3(v, spp):
    return tuple(tile_split(c, spp) for c in v)


def tile_split_planes(x: torch.Tensor, spp: int, merge: bool = False):
    """Split (or merge) a stacked (N, P, K) plane tensor."""
    n, p = x.shape[0], x.shape[1]
    flat = x.reshape(n, p, -1)
    fn = tile_merge if merge else tile_split
    return torch.stack([fn(flat[i], spp) for i in range(n)]).reshape(x.shape)


def schedule(o, d, tmax: torch.Tensor, tmin: float, sparse: str, group: int):
    """The wave ``(o, d, tmax)`` (Vec3s and window of (P, K)) in the order
    ``sparse`` gives a consensus sweep (``raytpu/ops/trace.py:188-209``),
    and ``back``, which puts a result in frame order again: a (P, K) plane
    or a stacked (N, P, K) tensor. ``"sort"`` re-bins where a segment length
    divides P; ``"split"``/``"split_all"`` regroup where ``group`` (the
    wave's spp fold) is 2 or 4 and :func:`can_split` holds; otherwise, and
    under ``"off"``, the wave is left as it is."""
    p, k = tmax.shape
    if sparse == "sort":
        sigma, rank, seg = rebin_perm(octant_key(d, tmax > tmin))
        if seg:
            def back(x):
                return (permute_planes(x, rank) if x.dim() == 3
                        else permute(x, rank))
            return (permute_vec3(o, sigma), permute_vec3(d, sigma),
                    permute(tmax, sigma), back)
    elif sparse in ("split", "split_all") and group in (2, 4) \
            and can_split(p, k, group):
        def back(x):
            return (tile_split_planes(x, group, merge=True) if x.dim() == 3
                    else tile_merge(x, group))
        return (tile_split_vec3(o, group), tile_split_vec3(d, group),
                tile_split(tmax, group), back)
    return o, d, tmax, lambda x: x
