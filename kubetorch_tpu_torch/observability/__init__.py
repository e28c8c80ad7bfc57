"""Observability pieces the port's engine uses: spans, the flight
recorder and device utilization."""
