"""Launch helpers of the port: the device meshes (``launch.mesh``), the
roofline and its counts (``launch.roofline``), the production-mesh dry
run (``launch.dryrun``) and its tables (``launch.report``)."""
