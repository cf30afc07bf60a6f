"""Local bundle adjustment on one device (`ba.py`); the sharded form is
not ported yet."""
