from .engine import Generator, make_serve_step

__all__ = ["Generator", "make_serve_step"]
