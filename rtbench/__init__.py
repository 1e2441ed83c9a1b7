"""The benchmark of ``raytpu_torch``, the PyTorch and CUDA port: the
interactive viewer's frame loop (``Renderer.step`` over a looping seeded
camera path), timed per frame on the card.

Everything here is found by name from ``BENCHMARK.json``: a configuration
is ``configs/<config>.json``, a traffic mix ``traffic/<traffic>.json`` read
by the one path generator ``camerapath.py``, which takes the poses of the
mix's kind from ``paths/<kind>.py``, a per-layer metric
``metrics/<metric>.py``, a cell's correctness limits
``limits/<cell>.json``, a mesh or sky generator ``meshes/<generator>.py`` /
``skies/<generator>.py``. ``reference/`` is the plain renderer that decides
``correct``; it imports nothing of the port.

Run a cell: ``python3 rtbench/run.py --workload config4.closeup --seed 7
--seconds 20 --trace 0``.
"""
