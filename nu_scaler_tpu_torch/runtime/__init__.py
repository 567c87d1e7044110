"""Runtime services of the port: frame pipelines, device memory and detection,
and the native frame ring of the capture stack."""
