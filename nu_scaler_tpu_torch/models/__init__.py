"""The learned super-resolution tier of the port."""
