"""multi_orbslam3_jax — a JAX collaborative visual(-inertial) SLAM engine.

A from-scratch JAX/XLA re-design of the capabilities of
yutongwangBIT/multi_orbslam3 (ORB-SLAM3 fused with CCM-SLAM's centralized
client/server multi-agent architecture; see /root/repo/SURVEY.md):

- ``geometry``  — SO3/SE3/Sim3 manifold ops + camera models (pure JAX).
- ``frontend``  — ORB pyramid extraction, FAST, BRIEF-256, batched Hamming
                  matching (replaces ORBextractor/ORBmatcher,
                  reference src/ORBextractor.cc, src/ORBmatcher.cc).
- ``bow``       — batched vocabulary-tree place recognition (replaces
                  DBoW2 + KeyFrameDatabase).
- ``map``       — fixed-capacity struct-of-arrays map store (replaces
                  Frame/KeyFrame/MapPoint/Map/Atlas object graphs).
- ``imu``       — IMU preintegration on manifold (replaces src/ImuTypes.cc).
- ``opt``       — batched robust Gauss-Newton/LM: pose-only, windowed local BA
                  with Schur complement, pose graph, Sim3 (replaces g2o +
                  src/Optimizer.cc).
- ``pipeline``  — tracking / local-mapping / loop-closing as host-orchestrated
                  jitted stages (replaces the reference's pthreads).
- ``collab``    — client/server map-delta protocol + server fusion + distributed
                  global BA over a device mesh (replaces Communicator/ROS).
- ``dataio``    — EuRoC/TUM loaders + synthetic sequence generator (replaces
                  rosbag ingestion).
- ``eval``      — ATE-RMSE trajectory evaluation.
"""

__version__ = "0.1.0"
