"""Front-end, pose engines and the end-to-end pipeline of the port."""
