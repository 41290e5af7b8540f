"""Entry points: the batched LM serving loop (``launch.serve``), the
trainer (``launch.train``: one device, or a data-parallel mesh) and mesh
construction (``launch.mesh``)."""
