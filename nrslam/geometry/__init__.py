from nrslam.geometry import se3, cameras, triangulation
