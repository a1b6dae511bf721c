"""Halo-exchange applies of the periodic cross stencil on a space-sharded field.

The counterpart of ``halo_stencil_apply``, ``halo_cross_apply`` and
``halo_cross_apply_batched`` of ``pysdc_tpu/ops/pallas/stencil.py:294-434``
(``shard_map`` and ``ppermute`` there, no Pallas kernel of their own).  The
field's first spatial axis (``-2``) is cut into one slab of ``nloc`` rows for
each position along the mesh axis ``axis`` (:meth:`Mesh.positions`: on a
time x space mesh, the space positions of the time row the mesh is set to,
:meth:`Mesh.time_row`).  For each
slab:

1. the neighbours' ``rx`` edge rows are copied to its position (the two
   ``ppermute`` of the JAX function: the upper neighbour's last rows become
   the top ghost, the lower neighbour's first rows the bottom ghost, cyclically);
2. on a CUDA slab: ``torch.cat([top_ghost, slab, bottom_ghost], dim=-2)`` and
   one launch of kernel K1 (:func:`~pysdc_tpu_torch.ops.kernels.stencil.cross_stencil_2d`)
   on that ``(..., nloc + 2 rx, ny)`` slab, of which rows ``rx : rx + nloc``
   are kept.  K1 wraps along x only into the first and last ``rx`` rows, which
   are thrown away, so the kept rows are the JAX halo apply's.  K1's path
   depends on ``ny`` alone, so the slab takes the path the whole field would;
3. on a CPU slab: the JAX function's slices (the plain version);

and the results are gathered on the field's device.  A CUDA slab always
launches K1: no launch failure gives way to the slices.  ``shard_applies``
counts the slabs applied, on either route.
"""

from __future__ import annotations

import torch


def _radius(offs) -> int:
    return max((abs(int(s)) for s in offs), default=0)


def _scatter(u, mesh, axis, rx):
    """``(devices, slabs, top ghosts, bottom ghosts)``: one slab of rows per
    position along ``axis``, each with its neighbours' edge rows, on its device."""
    devices = mesh.positions(axis)
    n = len(devices)
    nloc = u.shape[-2] // n
    if u.shape[-2] % n:
        raise ValueError(f'{u.shape[-2]} rows do not divide over {n} positions of mesh axis {axis!r}')
    if rx > nloc:
        raise ValueError(f'stencil radius {rx} exceeds local shard size {nloc}')
    rows = u.split(nloc, dim=-2)
    slabs = [mesh.copy_to(rows[i].contiguous(), devices[i]) for i in range(n)]
    tops, bots = [], []
    for i in range(n):
        if rx > 0:
            # my last rows -> the next position's top ghost, my first rows -> the previous one's bottom ghost
            tops.append(mesh.copy_to(slabs[(i - 1) % n][..., nloc - rx:, :], devices[i]))
            bots.append(mesh.copy_to(slabs[(i + 1) % n][..., :rx, :], devices[i]))
        else:
            tops.append(None)
            bots.append(None)
    return devices, slabs, tops, bots


def _apply(u, mesh, terms, axis, plain):
    """The common frame: scatter, one K1 launch (CUDA) or ``plain`` (CPU) per slab, gather."""
    rx = _radius(terms[0][1])
    _, slabs, tops, bots = _scatter(u, mesh, axis, rx)
    out = []
    for slab, top, bot in zip(slabs, tops, bots):
        halo_cross_apply_batched.shard_applies += 1
        if slab.device.type == 'cuda':
            from pysdc_tpu_torch.ops.kernels.stencil import cross_stencil_2d

            ext = torch.cat([top, slab, bot], dim=-2) if rx > 0 else slab
            out.append(cross_stencil_2d(ext, terms)[..., rx:rx + slab.shape[-2], :])
        elif slab.device.type == 'cpu':
            out.append(plain(slab, top, bot, rx))
        else:
            raise ValueError(f'halo apply runs on cuda or cpu shards, got {slab.device}')
    return mesh.gather(out, u.device, dim=-2)


def _five_point_terms(c0, cx, cy):
    """The 5-point stencil as a tap table; the y table centred (a zero middle tap) so that K1 takes its bands path."""
    return ((float(cx), float(c0), float(cx)), (-1, 0, 1)), ((float(cy), 0.0, float(cy)), (-1, 0, 1))


def halo_stencil_apply(u, mesh, c0: float, cx: float, cy: float, axis: str = 'space'):
    """Periodic 5-point stencil on a ``(nx, ny)`` field sharded over ``axis``
    (its leading spatial dimension): 1-deep halo exchange + local stencil."""

    def plain(u_loc, top, bot, rx):
        ext = torch.cat([top, u_loc, bot], dim=0)
        up = torch.cat([ext[:, -1:], ext, ext[:, :1]], dim=1)  # wrap along y
        return (c0 * up[1:-1, 1:-1] + cx * (up[2:, 1:-1] + up[:-2, 1:-1])
                + cy * (up[1:-1, 2:] + up[1:-1, :-2]))

    return _apply(u, mesh, _five_point_terms(c0, cx, cy), axis, plain)


def halo_cross_apply(u, mesh, terms, axis: str = 'space'):
    """Arbitrary-width periodic cross stencil on a ``(nx, ny)`` field whose
    leading spatial axis is sharded over ``axis``.  ``terms = ((coeff_x,
    offs_x), (coeff_y, offs_y))`` as in ``cross_stencil_2d``; an ``rx``-deep
    halo travels each way once, whatever the order."""
    (coeff_x, offs_x), (coeff_y, offs_y) = terms
    ry = _radius(offs_y)

    def plain(u_loc, top, bot, rx):
        nloc = u_loc.shape[0]
        ext = torch.cat([top, u_loc, bot], dim=0) if rx > 0 else u_loc
        up = torch.cat([ext[:, ext.shape[1] - ry:], ext, ext[:, :ry]], dim=1) if ry > 0 else ext
        ny = up.shape[1] - 2 * ry
        acc = torch.zeros_like(u_loc)
        for c, s in zip(coeff_x, offs_x):
            acc = acc + c * up[rx + s:rx + s + nloc, ry:ry + ny]
        for c, s in zip(coeff_y, offs_y):
            acc = acc + c * up[rx:rx + nloc, ry + s:ry + s + ny]
        return acc

    return _apply(u, mesh, terms, axis, plain)


def halo_cross_apply_batched(u, mesh, terms, axis: str = 'space'):
    """Arbitrary-width periodic cross stencil with leading batch axes, the
    first spatial axis (``-2``) sharded over ``axis``: the production
    space-decomposed apply.  The plain version is the JAX function's overlap
    form: the y taps and the in-range part of every x tap from the slab
    alone, then the edge rows corrected from the arrived ghosts."""
    (coeff_x, offs_x), (coeff_y, offs_y) = terms

    def plain(u_loc, top, bot, rx):
        nloc = u_loc.shape[-2]
        acc = torch.zeros_like(u_loc)
        for c, s in zip(coeff_y, offs_y):
            acc = acc + float(c) * torch.roll(u_loc, -int(s), dims=-1)
        for c, s in zip(coeff_x, offs_x):
            s = int(s)
            if s == 0:
                acc = acc + float(c) * u_loc
            elif s > 0:
                zeros = u_loc.new_zeros(u_loc.shape[:-2] + (s, u_loc.shape[-1]))
                acc = acc + float(c) * torch.cat([u_loc[..., s:, :], zeros], dim=-2)
            else:
                zeros = u_loc.new_zeros(u_loc.shape[:-2] + (-s, u_loc.shape[-1]))
                acc = acc + float(c) * torch.cat([zeros, u_loc[..., :s, :]], dim=-2)
        if rx > 0:
            top_corr = torch.zeros_like(acc[..., :rx, :])
            bot_corr = torch.zeros_like(acc[..., :rx, :])
            for c, s in zip(coeff_x, offs_x):
                s = int(s)
                if s < 0:  # rows i < -s read ghost rows above: top[rx + s + i]
                    top_corr[..., :-s, :] += float(c) * top[..., rx + s:, :]
                elif s > 0:  # rows i >= nloc - s read ghost rows below
                    bot_corr[..., rx - s:, :] += float(c) * bot[..., :s, :]
            acc[..., :rx, :] += top_corr
            acc[..., nloc - rx:, :] += bot_corr
        return acc

    return _apply(u, mesh, terms, axis, plain)


halo_cross_apply_batched.shard_applies = 0
