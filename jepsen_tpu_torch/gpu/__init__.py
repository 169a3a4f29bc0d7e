"""Device-side checking: encoding, the WGL frontier search and its
host orchestration, and verdict certificates."""
