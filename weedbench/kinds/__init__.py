"""Traffic generators, one module a kind. A mix's JSON names its kind;
the module gives prepare(run), measure(run, t0) -> setup_s, release(run),
check(run) -> {name: {value, limit}}, end_to_end(run) -> {name: value}
and info(run) -> {name: anything}, printed to standard error and never
compared.
"""
