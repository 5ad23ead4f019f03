"""Launch helpers of the port: the engine's device mesh (``launch.mesh``)."""
