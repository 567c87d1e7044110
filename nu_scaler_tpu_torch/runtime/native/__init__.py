"""Host C++ libraries of the port's runtime: the frame ring and the Y4M demuxer."""
