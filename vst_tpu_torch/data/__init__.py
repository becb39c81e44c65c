"""Host-side data sources of the port."""
