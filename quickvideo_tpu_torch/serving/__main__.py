from quickvideo_tpu_torch.serving.server import main

if __name__ == "__main__":
    main()
