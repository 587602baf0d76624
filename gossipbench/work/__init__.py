"""The least work of a call, from the plan's shapes and the trials a
call: bytes each input and output needs (each byte once) and the
operations the draw's hashes need.  The per-layer metrics divide
device time into these; nothing here reads a clock."""
