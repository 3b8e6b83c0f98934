"""Host-side data loading of the port."""
