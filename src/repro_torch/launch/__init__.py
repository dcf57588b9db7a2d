"""Entry points of the port: serving (``python -m
repro_torch.launch.serve``), training (``launch.train``) and the meshes
the sharded paths run on (``launch.mesh``)."""
