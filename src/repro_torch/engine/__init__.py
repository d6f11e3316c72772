"""The data-plane protocol, the BWKM driver and the in-core plane."""
