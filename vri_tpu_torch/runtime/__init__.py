"""Host runtime of the port: the scene cache (``cache``), scene validation
(``checks``) and profiling spans, traces and frame statistics
(``profiler``)."""
