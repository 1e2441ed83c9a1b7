"""The plain reference that decides ``correct``: the viewer's Whitted frame
(jittered raygen, closest hits and hard shadows against the triangles
themselves, mirror and refractive continuations, Blinn-Phong diffuse
shading, the bilinear cube-map sky, the mean over samples) in plain
PyTorch, at chosen pixels. It imports nothing of the port: its camera
basis, animation transforms, sky sampling and intersection are its own
(``scene_math.py``, ``whitted.py``)."""
