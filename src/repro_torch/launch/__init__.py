"""Entry points: the batched LM serving loop (``launch.serve``), the
trainer (``launch.train``: one device, or a mesh), mesh construction
(``launch.mesh``) and the dry run (``launch.dryrun``: one step of each
(arch x shape x mesh) cell on the ``meta`` device, counted by
``launch.op_analysis``; the one entry point that needs no card)."""
