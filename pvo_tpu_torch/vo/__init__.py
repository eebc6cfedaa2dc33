"""Visual odometry: network, inference DBA, video state, factor graph,
motion filter, frontend, backend and the system facade."""
