"""Host mesh I/O of the port (copies of ``raytpu/io``)."""
