"""Entry points: the batched LM serving loop (``launch.serve``) and the
single-process trainer (``launch.train``)."""
