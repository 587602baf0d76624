"""The plain reference the benchmark holds the port against: its own
plan (`plan`) and its own execution of the trials (`execute`), in numpy
and plain torch, importing nothing of the port."""
