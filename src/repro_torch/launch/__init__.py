"""Entry points: the batched LM serving loop (``launch.serve``)."""
