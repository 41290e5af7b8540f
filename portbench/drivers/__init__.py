"""A run's driver, one a kind of traffic (``traffic/<mix>.json``'s
"driver"): ``run(cell, seed, seconds, trace)`` returns the result's
fields."""
