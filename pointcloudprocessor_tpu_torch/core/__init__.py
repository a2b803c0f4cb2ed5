"""SE(3) math and the point-cloud container."""
