"""One module a model kind: how the port's engine for it is built from a
configuration file and driven by the traffic loops, and which of the
reference's forwards it is judged against. A configuration file names its
kind in "kind"."""
